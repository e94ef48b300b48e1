"""The numpy layer the port shares with the JAX package, in one place.

The configuration dataclasses and the output-vector layout, the grid's
label encoding and normalization, the dataset loader and its epoch order,
the loss log and progress plot, and the overlay/CSV renderer are plain
numpy in `spnet_tpu` (none of them imports jax).  The port takes them from
there, so that both packages read the same `experiment.json`, encode the
same labels and draw minibatches in the same order.  This module is the
only place in the port that names the JAX package; everything else, and
`chip_smoke.py`, imports these names from here.
"""

from spnet_tpu.config import (  # noqa: F401
    IND_A,
    IND_ANGLE1,
    IND_ANGLE2,
    IND_B,
    IND_CX,
    IND_CY,
    IND_NOOBJ,
    IND_RINGS,
    ORIG_IMG_HEIGHT,
    ORIG_IMG_WIDTH,
    VARS_PER_PRED,
    ExperimentConfig,
    GridSpec,
    LossWeights,
    ModelConfig,
    TrainConfig,
)
from spnet_tpu.data.dataset import (  # noqa: F401
    Dataset,
    batches,
    build_dataset,
    build_x,
    nearest_multiple,
)
from spnet_tpu.grid import (  # noqa: F401
    batch_ellipses_to_grid,
    canonicalize_records,
    denormalize,
    normalize,
)
from spnet_tpu.io.logs import LossLog, save_progress_plot  # noqa: F401
from spnet_tpu.io.render import show_pred_ellipses  # noqa: F401
