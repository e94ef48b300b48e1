"""The port's chunked feed (`spnet_tpu_torch/train/chunked.py`) against
the JAX package's on the CPU: `plan_chunks` gives JAX's integers over a
grid of arguments; `run_chunked_epoch` visits the same chunks and hands
its step the same within-chunk indices as JAX's (stand-in steps that
record their arguments, 2 epochs x 2 repeats, JAX's epoch argument
`epoch * repeats + r`); the staging hands out the host rows; and
`train_network(device_data="chunked")` keeps JAX's step count when the
chunks drop the set's tail (ROADMAP C31)."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.train import chunked as jchunked
from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.train import chunked, loop

torch.set_num_threads(2)


@pytest.mark.parametrize("batch_size", [1, 4, 16, 128])
def test_plan_chunks_matches_jax(batch_size):
    """The same (chunk_len, n_chunks) for the same arguments over a grid
    of set sizes, frame sizes and budgets, wherever JAX's plan is defined
    (a set of fewer than one batch divides by 0 in both)."""
    for n_items, item_bytes, budget in itertools.product(
            (7, 64, 1000, 50_000), (1, 3, 109_561),
            (0, 10_000, 12 * 1024**3)):
        if n_items < batch_size:
            for fn in (jchunked.plan_chunks, chunked.plan_chunks):
                with pytest.raises(ZeroDivisionError):
                    fn(n_items, item_bytes, batch_size, budget)
            continue
        assert chunked.plan_chunks(n_items, item_bytes, batch_size,
                                   budget) == jchunked.plan_chunks(
            n_items, item_bytes, batch_size, budget)


def _arrays(n, size=4):
    """x (n, size, size, 1) uint8 and y (n, 8) whose first lane is the
    frame's index, so a chunk names itself."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8)
    y = rng.random((n, 8), dtype=np.float32)
    y[:, 0] = np.arange(n)
    return x, y


def _jax_visits(x, y, chunk_len, n_chunks, batch_size, epochs, repeats,
                seed):
    """(chunk, idx_mat) per chunk visit of JAX's run_chunked_epoch, with
    the loop's epoch argument epoch * repeats + r."""
    rec = []

    def step(state, xc, yc, idx_mat, key):
        rec.append((int(np.asarray(yc)[0, 0]) // chunk_len,
                    np.asarray(idx_mat)))
        return state, jnp.zeros(idx_mat.shape[0])

    streamer = jchunked.ChunkStreamer((x, y), chunk_len, n_chunks)
    for epoch in range(epochs):
        for r in range(repeats):
            jchunked.run_chunked_epoch(step, None, streamer, batch_size,
                                       jax.random.key(0),
                                       epoch * repeats + r, seed)
    return rec


def _port_visits(x, y, chunk_len, n_chunks, batch_size, epochs, repeats,
                 seed):
    """The same from the port's run_chunked_epoch, whose step takes one
    row of idx_mat at a time: the rows of a chunk are stacked back."""
    rec, gen = [], torch.Generator()

    def step(state, xc, yc, idx, generator):
        assert generator is gen
        c = int(yc[0, 0]) // chunk_len
        np.testing.assert_array_equal(
            xc.numpy(), x[c * chunk_len:(c + 1) * chunk_len])
        if rec and rec[-1][0] == c and len(rec[-1][1]) < \
                chunk_len // batch_size:
            rec[-1][1].append(idx.numpy())
        else:
            rec.append((c, [idx.numpy()]))
        state.append(idx)
        return state, {"loss": torch.tensor(float(len(state)))}

    streamer = chunked.ChunkStreamer((x, y), chunk_len, n_chunks,
                                     torch.device("cpu"))
    state, means = [], []
    for epoch in range(epochs):
        for r in range(repeats):
            state, mean, nb = chunked.run_chunked_epoch(
                step, state, streamer, batch_size, gen,
                epoch * repeats + r, seed)
            assert nb == chunk_len // batch_size * n_chunks
            means.append(float(mean))
    # the mean of each pass's step losses 1..nb, nb+1..2nb, ...
    nb = chunk_len // batch_size * n_chunks
    assert means == [np.mean(np.arange(k * nb + 1, (k + 1) * nb + 1))
                     for k in range(epochs * repeats)]
    return [(c, np.stack(rows)) for c, rows in rec]


@pytest.mark.parametrize("n,batch_size,budget_items", [
    (64, 4, 48),    # 4 chunks of 16
    (70, 4, 30),    # 7 chunks of 8 and a dropped tail of 14
    (50, 8, 1000),  # one chunk of 48
])
def test_run_chunked_epoch_visits_match_jax(n, batch_size, budget_items):
    """2 epochs x 2 repeats: the chunks in JAX's order, each with JAX's
    (steps, batch) index matrix, and each chunk's tensors the host
    slice."""
    x, y = _arrays(n)
    item = x[0].nbytes + y[0].nbytes
    chunk_len, n_chunks = chunked.plan_chunks(n, item, batch_size,
                                              budget_items * item)
    args = (x, y, chunk_len, n_chunks, batch_size, 2, 2, 11)
    want, got = _jax_visits(*args), _port_visits(*args)
    assert len(got) == len(want) == 4 * n_chunks
    for (gc, gi), (wc, wi) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gi, wi)


def test_stager_hands_out_the_host_rows():
    """On the CPU a put of a slice or of an index array gives those rows
    of every array; `stream_rows` keeps the order it is given."""
    x, y = _arrays(20)
    st = chunked.Stager((x, y), 5, torch.device("cpu"))
    xs, ys = st.take(st.put(slice(5, 10)))
    np.testing.assert_array_equal(xs.numpy(), x[5:10])
    np.testing.assert_array_equal(ys.numpy(), y[5:10])
    rows = np.array([[3, 1, 4, 0], [19, 2, 7, 8]])
    got = list(st.stream_rows(rows))
    assert len(got) == 2
    for r, (xb, yb) in zip(rows, got):
        np.testing.assert_array_equal(xb.numpy(), x[r])
        np.testing.assert_array_equal(yb.numpy(), y[r])
    assert list(st.stream_rows(rows[:0])) == []


SIZE = 32
CFG = ExperimentConfig(
    model=ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                      compute_dtype="float32"),
    train=TrainConfig(batch_size=4, epochs=2, save_every=1, seed=5,
                      augment=False))


def _dataset(n, seed):
    rng = np.random.default_rng(seed)
    return Dataset(x=rng.integers(0, 256, (n, SIZE, SIZE, 1), np.uint8),
                   y=rng.random((n, 576), dtype=np.float32), grid=CFG.grid,
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)])


def test_chunked_step_count_keeps_jax_semantics(tmp_path):
    """ROADMAP C31, kept as in JAX: 20 frames at b=4 in chunks of 8 (the
    tail of 4 dropped) run 2 chunks x 2 steps an epoch, while the schedule
    and the resume count 20 // 4 = 5 an epoch.  So after 2 epochs the step
    is 8, and the same run asked again for 2 epochs resumes at epoch 2
    (8 // 5 = 1) and trains it once more."""
    train, val = _dataset(20, 1), _dataset(4, 2)
    item = train.x[0].nbytes + train.y[0].nbytes
    kw = dict(device_data="chunked", chunk_budget=3 * 8 * item,
              render_overlays=False, verbose=0)
    state, hist = loop.train_network(CFG, train, val, "cpu",
                                     log_dir=str(tmp_path / "a"),
                                     ckpt_dir=str(tmp_path / "ck"), **kw)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert state.step == state.opt_state.count == 2 * 4
    state, hist = loop.train_network(CFG, train, val, "cpu",
                                     log_dir=str(tmp_path / "b"),
                                     ckpt_dir=str(tmp_path / "ck"), **kw)
    assert [h["epoch"] for h in hist] == [1]
    assert state.step == 8 + 4


def test_chunked_training_resumes_like_an_unbroken_run(monkeypatch,
                                                      tmp_path):
    """Chunked feed, 2 repeats, whole chunks (16 frames, chunks of 8): a
    run cut after epoch 1's checkpoint and resumed ends bitwise where an
    unbroken one does (the chunk order and the generator are seeded by
    the epoch)."""
    from spnet_tpu_torch.io.checkpoint import save_train_state

    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, epoch_repeats=2, augment=True))
    train, val = _dataset(16, 3), _dataset(4, 4)
    item = train.x[0].nbytes + train.y[0].nbytes
    kw = dict(device_data="chunked", chunk_budget=3 * 8 * item,
              render_overlays=False, verbose=0)
    whole, hist = loop.train_network(cfg, train, val, "cpu",
                                     log_dir=str(tmp_path / "w"), **kw)

    class Cut(Exception):
        pass

    def save_then_cut(*args, **kwargs):
        save_train_state(*args, **kwargs)
        raise Cut

    monkeypatch.setattr(loop, "save_train_state", save_then_cut)
    with pytest.raises(Cut):
        loop.train_network(cfg, train, val, "cpu",
                           log_dir=str(tmp_path / "c"),
                           ckpt_dir=str(tmp_path / "ck"), **kw)
    monkeypatch.setattr(loop, "save_train_state", save_train_state)
    resumed, hist_b = loop.train_network(cfg, train, val, "cpu",
                                         log_dir=str(tmp_path / "r"),
                                         ckpt_dir=str(tmp_path / "ck"), **kw)
    assert whole.step == resumed.step == 2 * 2 * 4
    assert [h["epoch"] for h in hist_b] == [1]
    assert hist_b[-1]["train_loss"] == hist[-1]["train_loss"]
    for (k, a), b in zip(whole.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
