"""Port parity for the probe kernels' plain versions and their tools (CPU):
``fetch_plain`` against ``jnp.take`` and against the four Pallas fetch
probes of ``tools/pallas_gather_probe.py`` run in the TPU interpret mode;
``floor_shell_plain`` against ``tools/micro_floor.py:build_arm``; the port's
wrappers' argument checks; and the two tool mains at a tiny size. The CUDA
kernels themselves run emulated in tests/test_torch_cuda_emu.py and on the
card in chip_smoke.py."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pienerf_tpu_torch.kernels import probes as tpr
from pienerf_tpu_torch.tools import gather_probe, micro_floor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """A tool of the JAX package, loaded from its file (tools/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(T, B, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, tpr.ROW).astype(np.float32),
            rng.randint(0, T, B).astype(np.int32))


def test_fetch_plain_equals_jnp_take():
    table, idx = _table(300, 1024)
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    out = tpr.fetch_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)
    lib = torch.index_select(torch.from_numpy(table), 0,
                             torch.from_numpy(idx))    # the tool's arm C
    np.testing.assert_array_equal(lib.numpy(), ref)


@pytest.mark.parametrize("name,port", [
    ("onehot_fetch", tpr.onehot_fetch), ("dma_fetch", tpr.dma_fetch),
    ("vmem_take_fetch", tpr.take_fetch),
    ("dynslice_fetch", tpr.dynslice_fetch)])
def test_fetch_wrappers_equal_pallas_probes_interpreted(name, port):
    """Each Pallas probe, run as it stands in the TPU interpret mode, and
    its port (the plain version, on CPU tensors) fetch the same rows."""
    tool = _jax_tool("pallas_gather_probe")
    T, B = 64, 2048
    table, idx = _table(T, B, seed=1)
    kw = {"chunk": T} if name == "onehot_fetch" else {}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(getattr(tool, name)(jnp.asarray(table),
                                             jnp.asarray(idx), **kw))
    out = port(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fetch_wrappers_check_their_arguments():
    table, idx = _table(64, 512)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError):          # rows must be 128 wide
        tpr.take_fetch(t[:, :64], i)
    for fn in (tpr.onehot_fetch, tpr.dma_fetch, tpr.dynslice_fetch):
        with pytest.raises(ValueError):      # whole blocks of 512 indices
            fn(t, i[:100])
    assert tpr.take_fetch(t, i[:100]).shape == (100, tpr.ROW)
    assert all(fn.launches == 0 for fn in tpr.FETCH_FNS.values())
    with pytest.raises(ValueError):
        tpr.floor_shell(torch.zeros((4, 8)), block_tiles=0)
    with pytest.raises(ValueError):
        micro_floor.arm_inputs("no-such-arm", torch.zeros((4, 8)), 8, 8)


@pytest.mark.parametrize("arm,kw", [
    ("full", {}), ("smem-only", dict(use_cand=False, use_dirs=False))])
def test_floor_shell_plain_equals_build_arm_interpreted(arm, kw):
    """build_arm's kernel at its fixed A = 1248, B = 4 with some tiles
    active: zeros, and 1 in row 0 of the active tiles."""
    tool = _jax_tool("micro_floor")
    rng = np.random.RandomState(2)
    sc = np.zeros((tool.A, 1, 8), np.float32)
    sc[:, 0, 2] = rng.randint(0, 2, tool.A)
    run, bs = tool.build_arm(**kw)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run(
            jnp.asarray(sc), bs, jnp.ones((tool.A, 8, tool.T2), jnp.float32),
            jnp.zeros((tool.A, tool.P, 16), jnp.float32), jnp.float32(0.0)))
    tile_sc = torch.from_numpy(sc[:, 0])
    out = tpr.floor_shell(*micro_floor.arm_inputs(arm, tile_sc, tool.BS,
                                                  tool.P))
    assert ref[:, 0].max() == 1.0 and ref[:, 0].min() == 0.0
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tpr.floor_shell.launches == 0     # CPU tensors launch nothing


def test_gather_probe_main_cpu():
    res = gather_probe.main(["--device", "cpu", "--rows", "512", "--tables",
                             "64", "16384", "--reps", "1"])
    names = set(res) - {"device", "unique_rows"}
    assert res["unique_rows"][64] == 64 and res["unique_rows"][16384] <= 512
    assert names == {
        "A_onehot_T64", "B_dynslice_T64", "E_take_T64", "C_index_select_T64",
        "D_dma_T64", "B_dynslice_T16384", "E_take_T16384",
        "C_index_select_T16384", "D_dma_T16384"}     # no one-hot above 2^13
    assert all(res[n]["ms_per_call"] > 0 and res[n]["rows_per_s"] > 0
               for n in names)
    assert res["device"].startswith("cpu")


def test_tool_mains_run_as_modules_and_refuse_without_a_card(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "pienerf_tpu_torch.tools.micro_floor",
         "--device", "cpu", "--tiles", "8", "--reps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert [k for k in last["ms"] if not k.endswith("_eager")] == list(
        micro_floor.ARMS)
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    for tool in (gather_probe, micro_floor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([])


def test_fetch_wrappers_refuse_a_table_off_16_bytes():
    """The fetch kernels move rows as 16-byte vectors and the dma arm's
    bulk copies take only 16-byte-aligned addresses: the wrappers check
    the table and out with ``check_aligned`` before a launch."""
    buf = torch.zeros(64 * tpr.ROW + 4)
    tpr.check_aligned(buf, "table")
    tpr.check_aligned(buf[4:], "table")               # 16 bytes in
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte"):
            tpr.check_aligned(buf[off:], "table")
