"""``ops/_build``: nvcc runs once per source, all at once, and each
compile's seconds and output are kept; a failed compile raises with its
output. A stand-in ``nvcc`` (a shell script under ``CUDA_HOME``) takes the
compiler's place, and the libraries go to a temporary directory."""

import os
import stat

import pytest

from alayalite_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
out=""
src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
case "$src" in
  *sq8_tile.cu) sleep 0.5; echo "ptxas warning : C7520 stand-in" ;;
  *ring_probe.cu) echo "error: stand-in"; exit 1 ;;
esac
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "kernels")
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "build_logs", {})
    return tmp_path


@pytest.mark.parametrize("names", [("pool_sort", "sq8_tile"),
                                   ("sq8_tile", "pool_sort")])
def test_build_times_each_source_and_keeps_its_output(fake_nvcc, names):
    built = _build.build(names)
    assert set(built) == set(names)
    for name, path in built.items():
        assert path.parent == fake_nvcc / "kernels" and path.exists()
        assert path == _build.lib_path(name)
    # the sleeping compile is timed alone, whichever order it was waited in
    assert _build.build_seconds["sq8_tile"] >= 0.5
    assert _build.build_seconds["pool_sort"] < 0.5
    assert "C7520" in _build.build_logs["sq8_tile"]
    assert _build.build_logs["pool_sort"] == ""
    assert not [p for p in os.listdir(fake_nvcc / "kernels")
                if not p.endswith(".so")]
    # up to date: nothing is compiled again
    _build.build_seconds.clear()
    assert _build.build(names) == built and not _build.build_seconds


def test_build_raises_with_the_compiler_output(fake_nvcc):
    with pytest.raises(RuntimeError, match="ring_probe.cu:\nerror: stand-in"):
        _build.build(["pool_sort", "ring_probe"])
    assert _build.lib_path("pool_sort").exists()
    assert not _build.lib_path("ring_probe").exists()
