"""The kernel build (`spnet_tpu_torch/ops/_build.py`) with a stand-in
`nvcc` on PATH: one compile per source, then one link, into a library
named by the hash of sources and flags; a cached library is reused, and a
failing compile raises with the command and the compiler's output."""

import os
import stat
import sys

import pytest

from spnet_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
bad = os.environ.get("FAKE_NVCC_FAIL")
if bad and any(a.endswith(bad) for a in args):
    print("error: planted failure in", bad)
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built\\n")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return log


def test_build_compiles_each_source_then_links_once(fake_nvcc):
    path, seconds = _build.build()
    assert path.exists() and seconds > 0
    assert path.parent == _build.BUILD_DIR
    calls = fake_nvcc.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                  for c in compiles) == sorted(_build.SOURCES)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1 and calls[-1] == links[0]
    assert all(c.split(" -c ")[1].split(" -o ")[1] in links[0]
               for c in compiles)
    # the same sources and flags: the library is reused, nothing runs
    assert _build.build() == (path, 0.0)
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)
    assert os.listdir(_build.BUILD_DIR) == [path.name]


def test_build_failure_raises_with_the_command_and_log(fake_nvcc,
                                                       monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "loss.cu")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        _build.build()
    msg = str(err.value)
    assert "loss.cu" in msg and "planted failure in loss.cu" in msg
    assert "sepconv.cu" not in msg  # only the failing compile is reported
    assert not _build.library_path().exists()
    assert not any("-shared" in c
                   for c in fake_nvcc.read_text().splitlines())
