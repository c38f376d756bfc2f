"""The kernel build (``kernels/_build.py``) without nvcc: a stand-in
compiler script takes nvcc's place, so that the start-all-then-poll loop,
the per-library times and the failure path run on the CPU."""

import os
import stat

import pytest

from pienerf_tpu_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# writes the -o file after a delay named by the source, and prints a log
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
done
case "$src" in *slow*) sleep 1;; *fail*) echo "error in $src"; exit 2;; esac
echo "ptxas info : Used 32 registers ($src)"
touch "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "out"))
    return monkeypatch


def test_build_reports_each_nvcc_by_its_own_end(fake_nvcc):
    """Every library's nvcc starts at once; each one's seconds run to its
    own end, so a fast source is not charged a slow one's time, and its
    log comes back. A second build finds the libraries and builds none."""
    fake_nvcc.setattr(_build, "SOURCES", {"slow": "slow.cu",
                                          "fast": "fast.cu"})
    rep = _build.build()
    assert rep["slow"]["built"] and rep["fast"]["built"]
    assert rep["fast"]["seconds"] < 0.9 <= rep["slow"]["seconds"]
    assert "Used 32 registers (" in rep["fast"]["log"]
    assert "fast.cu" in rep["fast"]["log"]
    assert all(os.path.exists(r["path"]) for r in rep.values())
    again = _build.build()
    assert not any(r["built"] for r in again.values())


def test_build_raises_with_the_failing_log(fake_nvcc):
    fake_nvcc.setattr(_build, "SOURCES", {"slow": "slow.cu",
                                          "bad": "fail.cu"})
    with pytest.raises(RuntimeError, match="nvcc failed for fail.cu"):
        _build.build()
    assert not os.path.exists(_build.lib_path("bad"))
