"""Measurement tools for the port's kernels and benchmarks (run on a CUDA
host), and the accuracy-validation tools of the JAX package's scripts
(`dataset_a`, `sanity_train`, `eval_breakdown`, `eval_tta`,
`movie_predict`, the Dataset-D experiment `dataset_d` with its data
stages `dataset_d_prep` and `dataset_d_inflate`, `eval_blur_split`, and
the reference-generator experiment `refgen_dataset` (host work) and
`refgen_run`; on the card unless asked for the CPU), the step profiler
`profile_step`, and the Keras-side diagnostics `keras_train_diff` and
`keras_h5_finetune` (they need tensorflow / keras: CPU hosts only)."""
