"""The port's data-preparation commands (`setup-data`, `augment`,
`parse-zooniverse`, `gen-bboxes`, `ellipse-editor`) against the JAX
package's on the same inputs, and `python -m spnet_tpu_torch --help`."""

import ast
import math
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spnet_tpu.cli import augment_preproc as j_augment
from spnet_tpu.cli import ellipse_editor as j_editor
from spnet_tpu.cli import gen_bboxes as j_bboxes
from spnet_tpu.cli import parse_zooniverse as j_zoo
from spnet_tpu.cli import setup_data as j_setup
from spnet_tpu.ops import augment as j_aug_ops
from spnet_tpu_torch.cli import augment_preproc, ellipse_editor, gen_bboxes, \
    parse_zooniverse, setup_data
from spnet_tpu_torch.data.csvio import paired_file_lists, read_raw_meta, \
    write_meta_file
from spnet_tpu_torch.data.synth import generate_dataset

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("train", "evaluate", "predict", "gen-fake-espi", "export",
            "setup-data", "augment", "parse-zooniverse", "gen-bboxes",
            "ellipse-editor")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """6 synthetic native frames with their CSVs (the port's generator on
    the CPU), plus one frame whose CSV has 20 rows (past augment's 16),
    one zero-ring row and one ellipse reaching past the frame."""
    d = str(tmp_path_factory.mktemp("frames"))
    generate_dataset(d, 6, seed=4, device="cpu", verbose=False)
    src = os.path.join(d, "Train")
    imgs, metas = paired_file_lists(src + os.sep)
    shutil.copy(imgs[0], os.path.join(src, "crowded.png"))
    rng = np.random.default_rng(2)
    rows = np.stack([rng.uniform(40, 470, 20), rng.uniform(40, 340, 20),
                     rng.uniform(20, 60, 20), rng.uniform(8, 20, 20),
                     rng.uniform(0, 180, 20), rng.integers(1, 11, 20)], 1)
    rows[3, 5] = 0.0  # no rings: gen-bboxes skips it
    rows[4, :2] = (505.0, 2.0)  # its box is clipped to the frame
    write_meta_file(os.path.join(src, "crowded.csv"), rows.tolist())
    return src


def _tree(d: str) -> dict:
    """{relative path: bytes} of every file under d (links followed)."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = pathlib.Path(p).read_bytes()
    return out


# ---------------------------------------------------------------------------
# parse-zooniverse
# ---------------------------------------------------------------------------


def test_parse_zooniverse_matches_jax(frames, tmp_path):
    """One aggregated CSV through both tools, twice (old outputs cleared,
    rows appended per image), with and without --no-copy: output
    directories byte-identical.  The CSV has a header, a b > a row
    (swapped, +90 degrees), an exact duplicate, a zero-ring row, a NaN row,
    a 6-field row, a `bmp.png` name, a missing image and float rings."""
    imgs, _ = paired_file_lists(frames + os.sep)
    b0, b1 = os.path.basename(imgs[0]), os.path.basename(imgs[1])
    lines = ["x,y,filename,fringe_count,rx,ry,angle",
             f"100,120,{b0},3,20,45,30",
             f"100,120,{b0},3,20,45,30",
             f"200,150,{b0},0,30,20,10",
             f"210,150,{b0},nan,30,20,10",
             f"210,150,{b0},4,30,20",
             f"250,200.5,{b0},5,60,25,100.25",
             f"300,90,{b1[:-4]}.bmp.png,2.5,40,41,170",
             "10,20,missing_frame.png,1,5,4,0"]
    agg = tmp_path / "agg.csv"
    agg.write_text("\n".join(lines) + "\n")
    for copy_args in ([], ["--no-copy"]):
        outs = {}
        for tag, tool in (("jax", j_zoo), ("port", parse_zooniverse)):
            out = str(tmp_path / f"{tag}{len(copy_args)}")
            for _ in range(2):
                tool.main(["-i", str(agg), "-p", frames, "-o", out]
                          + copy_args)
            outs[tag] = _tree(out)
        assert outs["port"] == outs["jax"]
        assert len(outs["port"]) == (3 if copy_args else 5)
    assert parse_zooniverse.parse_zooniverse_csv(
        str(agg), frames, str(tmp_path / "n")) == 4


# ---------------------------------------------------------------------------
# gen-bboxes
# ---------------------------------------------------------------------------


def test_gen_bboxes_matches_jax(frames, tmp_path):
    """The CSV byte-identical, with the default label and with
    --label-by-rings (a zero-ring row skipped, a box clipped)."""
    for extra in ([], ["--label-by-rings"]):
        outs = []
        for tag, tool in (("jax", j_bboxes), ("port", gen_bboxes)):
            out = str(tmp_path / f"{tag}{len(extra)}.csv")
            tool.main(["-d", frames, "-o", out] + extra)
            outs.append(pathlib.Path(out).read_bytes())
        assert outs[0] == outs[1]
        text = outs[1].decode().splitlines()
        assert text[0] == "filename,width,height,label,xmin,ymin,xmax,ymax"
        crowded = [t for t in text if t.startswith("crowded.png")]
        assert len(crowded) == 19  # 20 rows, one without rings
        boxes = [[int(v) for v in t.split(",")[4:]] for t in crowded]
        assert any(x1 == 512 and y0 == 0 for x0, y0, x1, y1 in boxes)


@pytest.mark.parametrize("args", [
    (100, 100, 50, 20, 0, False), (100, 100, 50, 20, 90, False),
    (256.5, 191.25, 80.3, 30.7, 37.5, True), (5, 380, 60, 40, 145, True),
    (510, 3, 90, 10, 179.9, True), (-20, 200, 30, 30, 0, True),
    (300, 100, 1e-3, 1e-3, 60, True)])
def test_ellipse_bbox_matches_jax(args):
    *geom, clip = args
    assert gen_bboxes.ellipse_bbox(*geom, clip=clip) == \
        j_bboxes.ellipse_bbox(*geom, clip=clip)


# ---------------------------------------------------------------------------
# setup-data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1])
def test_distribute_dataset_matches_jax(frames, tmp_path, k):
    """The 80/20 split of `random.Random(seed + k)`: Train/ and Val/ hold
    the same files as JAX's; copies for k = 0, symlinks for k > 0."""
    trees = {}
    for tag, tool in (("jax", j_setup), ("port", setup_data)):
        out = str(tmp_path / tag)
        assert tool.distribute_dataset(frames, out, k=k) == 7
        trees[tag] = _tree(out)
        for f in os.listdir(os.path.join(out, "Train")):
            assert os.path.islink(os.path.join(out, "Train", f)) == (k > 0)
    assert trees["port"] == trees["jax"]
    assert sum(p.startswith("Train") for p in trees["port"]) == 2 * 6


def test_setup_data_cli_matches_jax(frames, tmp_path):
    """`setup-data -k 2 -a 1` through both mains: the folds `name/` and
    `name_k2/`, old Test/ removed, Train/ inflated by one variant a file
    with JAX's names (the CPU for the port); the copied originals and
    every CSV byte-identical."""
    trees = {}
    for tag, tool, extra in (("jax", j_setup, []),
                             ("port", setup_data, ["--device", "cpu"])):
        name = str(tmp_path / tag / "ds")
        os.makedirs(os.path.join(name, "Test"))
        tool.main(["-o", frames, "--name", name, "-k", "2", "-a", "1"]
                  + extra)
        assert not os.path.exists(os.path.join(name, "Test"))
        trees[tag] = _tree(str(tmp_path / tag))
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert any(p.startswith("ds_k2" + os.sep) for p in trees["port"])
    n_train = sum(p.startswith(os.path.join("ds", "Train")) and
                  p.endswith(".png") for p in trees["port"])
    assert n_train == 2 * 6  # 6 originals + 6 variants
    for p, data in trees["port"].items():
        if p.endswith(".csv") or "_r" not in p:
            assert data == trees["jax"][p], p


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------


def test_augment_matches_jax(frames, tmp_path):
    """`augment -n 12` (seed 0) of the 7 pairs through both mains, the
    port on the CPU: identical file names; every CSV row within 1e-4
    (measured: equal); the pixels of each variant equal but for a share
    of 1e-3 (measured 5.1e-5, up to 189 gray levels apart: JAX's jitted
    `_augment_one` fuses the sampling arithmetic, and the f32 cos / sin
    differ by an ulp between XLA and torch, so a few samples land on the
    other side of a pixel boundary; op by op the warps agree within 0.05,
    test_warp_matches_jax_op_by_op); a crowded file keeps 16 rows."""
    dirs = {}
    for tag, tool, extra in (("jax", j_augment, []),
                             ("port", augment_preproc, ["--device", "cpu"])):
        d = str(tmp_path / tag)
        shutil.copytree(frames, d)
        tool.main(["-d", d, "-n", "12"] + extra)
        dirs[tag] = d
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert len(names) == 2 * 7 * 13
    differ = total = 0
    for f in names:
        pj, pp = (os.path.join(dirs[t], f) for t in ("jax", "port"))
        if f.endswith(".csv"):
            rj, rp = read_raw_meta(pj), read_raw_meta(pp)
            assert rj.shape == rp.shape, f
            np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-4,
                                       err_msg=f)
            if f.startswith("crowded_"):
                assert rp.shape[0] == augment_preproc.MAX_ROWS
        else:
            a = np.asarray(Image.open(pj), np.int16)
            b = np.asarray(Image.open(pp), np.int16)
            differ += int((a != b).sum())
            total += a.size
    assert differ <= 1e-3 * total, differ / total


def test_warp_matches_jax_op_by_op(frames):
    """Each of a file's variants (JAX's draws): the port's flip -> rotate
    -> translate against JAX's run op by op (`jax.disable_jit`): the image
    within 0.05 gray levels (measured 0.0116: the f32 cos / sin of one
    angle an ulp apart; 5 of 6 variants bitwise), the rows within 1e-4
    (measured: equal).  Some warped pixel has a fraction above .5 below
    255, where the tool's truncating cast and a rounding one part."""
    img_path = os.path.join(frames, "crowded.png")
    img = np.asarray(Image.open(img_path), np.float32)[..., None]
    raw = read_raw_meta(os.path.join(frames, "crowded.csv"))
    rows = np.zeros((augment_preproc.MAX_ROWS, 6), np.float32)
    rows[:] = raw[:augment_preproc.MAX_ROWS]
    mask = np.ones(augment_preproc.MAX_ROWS, bool)
    rng = np.random.default_rng(0)
    truncated = False
    for _ in range(6):
        flip_sel, rot, tx, ty = augment_preproc.draw_variant(rng)
        mode = augment_preproc.FLIPS[flip_sel][0]
        with jax.disable_jit():
            ji, jr = j_aug_ops.flip_image_and_labels(
                jnp.asarray(img), jnp.asarray(rows), jnp.asarray(mask), mode)
            ji, jr = j_aug_ops.rotate_image_and_labels(ji, jr,
                                                       jnp.asarray(mask), rot)
            ji, jr = j_aug_ops.translate_image_and_labels(
                ji, jr, jnp.asarray(mask), tx, ty)
        ti, tr = augment_preproc.warp_variant(
            torch.from_numpy(img.copy()), torch.from_numpy(rows),
            torch.from_numpy(mask), flip_sel, rot, tx, ty)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                                   atol=0.05)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-4)
        frac = ti.numpy() - np.floor(ti.numpy())
        truncated |= bool(((frac > 0.5) & (ti.numpy() < 255)).any())
    assert truncated  # some pixel rounds up but truncates down


def test_augment_writes_truncated_pixels(frames, tmp_path):
    """The written variant is np.clip(warp, 0, 255).astype(uint8) of the
    port's own warp, bit for bit."""
    d = tmp_path / "one"
    d.mkdir()
    for ext in (".png", ".csv"):
        shutil.copy(os.path.join(frames, "crowded" + ext), d)
    augment_preproc.augment_data(str(d), n_augs=1, seed=3, device="cpu")
    v = augment_preproc.draw_variant(np.random.default_rng(3))
    img = np.asarray(Image.open(d / "crowded.png"), np.float32)[..., None]
    raw = read_raw_meta(str(d / "crowded.csv"))
    rows = np.zeros((augment_preproc.MAX_ROWS, 6), np.float32)
    rows[:] = raw[:augment_preproc.MAX_ROWS]
    warped, _ = augment_preproc.warp_variant(
        torch.from_numpy(img), torch.from_numpy(rows),
        torch.ones(augment_preproc.MAX_ROWS, dtype=torch.bool), *v)
    want = np.clip(warped.numpy(), 0, 255).astype(np.uint8)[..., 0]
    got = np.asarray(Image.open(
        d / f"crowded{augment_preproc.variant_suffix(*v)}.png"))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ellipse-editor, the command list
# ---------------------------------------------------------------------------


def test_editor_ellipse_matches_jax(tmp_path):
    """The editor's data model: rows, outline points, handles and
    hit-testing on a grid equal to JAX's for a few ellipses (including
    degenerate axes), and its CSV save / reload round trip through the
    port's csvio.  The module imports tkinter only inside EditorApp and
    main, so it loads without a display."""
    cases = [(100.0, 100.0, 50.0, 20.0, 30.0, 2), (256.5, 191.25, 80.0,
             80.0, 0.0, 11), (10.0, 370.0, 35.5, 12.25, 149.97, 1.5),
             (300.0, 200.0, 0.0, 10.0, 90.0, 3)]
    for args in cases:
        e, je = ellipse_editor.Ellipse(*args), j_editor.Ellipse(*args)
        assert e.row() == je.row()
        assert e.poly_points() == je.poly_points()
        assert e.poly_points(n=9) == je.poly_points(n=9)
        assert e.handles() == je.handles()
        for x in range(0, 512, 13):
            for y in range(0, 384, 11):
                assert e.contains(x, y) == je.contains(x, y)
    path = str(tmp_path / "f.csv")
    write_meta_file(path, [ellipse_editor.Ellipse(*a).row() for a in cases])
    back = [ellipse_editor.Ellipse(*r).row()
            for r in read_raw_meta(path).tolist()]
    assert np.allclose(back, [list(a) for a in cases], rtol=0, atol=1e-6)
    tree = ast.parse(pathlib.Path(ellipse_editor.__file__).read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("tkinter" in ast.dump(n) for n in top)
    assert math.isclose(ellipse_editor.Ellipse(*cases[0]).handles()[0][0],
                        100.0 + 50.0 * math.cos(math.radians(-30.0)))


def test_cli_help_lists_every_command():
    """`python -m spnet_tpu_torch --help` names all 10 commands; each new
    one prints its own --help."""
    out = subprocess.run([sys.executable, "-m", "spnet_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120, check=True).stdout
    listed = [ln.split()[0] for ln in out.splitlines()
              if ln.startswith("  ") and ln.split()]
    assert [c for c in listed if c in COMMANDS] == list(COMMANDS)
    from spnet_tpu_torch.__main__ import _COMMANDS
    assert tuple(_COMMANDS) == COMMANDS
    for cmd in COMMANDS[5:]:
        res = subprocess.run([sys.executable, "-m", "spnet_tpu_torch", cmd,
                              "--help"], capture_output=True, text=True,
                             cwd=ROOT, timeout=120)
        assert res.returncode == 0 and "usage" in res.stdout, cmd
