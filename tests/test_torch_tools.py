"""The port's two probes against the JAX package's tools on the CPU: T1,
the sphere-sweep probe (``rtow_tpu_torch/tools/mxu_probe.py`` against
``tools/mxu_probe.py:_build`` in interpret mode), and T2, the
block-by-block table sum (``rtow_tpu_torch/tools/repro_nb_slice.py``
against ``tools/repro_nb_slice.py:make_kernel`` in interpret mode).  The
JAX tools are loaded by file path (``tools/`` is no package).  Both sides
get the same numpy inputs.

Tolerances:

* the h / c weights: bit-equal (both build them in float64 and round
  once);
* T1, every kind: per lane within 1e-5 of max(|JAX|, 1e-3) except at
  most 1% of the lanes, and no lane off by 1e-3.  XLA's CPU compiler
  rounds the quadratic's float32 operations otherwise than PyTorch's
  (measured at these sizes: 7.5% of the lanes differ, by up to 224 ulp
  of the output where disc = h^2 - a c cancels, 0.24% by more than 1e-5);
  the matrix forms' h and c are 16-term products that the two sum in
  other orders, and on the r = 1000 ground sphere c is ~1e3 times h
  (measured: up to 2,620 ulp, 0.78% of the lanes by more than 1e-5).  A
  one-hot product picks a value exactly, so on the port's side "mxu_f"
  equals "vpu" and "mxu_b" equals "mxu" bit for bit;
* T2: exact on a table of ones (every partial sum is an integer below
  2**24); 1e-5 relative on uniform [0, 1) data (the sum of each 16 x 128
  block is ordered differently by XLA and PyTorch).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu_torch.tools import mxu_probe, repro_nb_slice

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    return _load("mxu_probe")


@pytest.fixture(scope="module")
def jax_repro():
    return _load("repro_nb_slice")


N_BLOCKS, ITERS, N_TILES = 2, 2, 2


@pytest.fixture(scope="module")
def probe_inputs():
    return mxu_probe.inputs(N_BLOCKS, N_TILES, seed=11)


def test_mxu_weights_bit_equal(jax_probe, probe_inputs):
    tbl, w, _ = probe_inputs
    want = np.asarray(jax_probe._mxu_weights(jnp.asarray(tbl)))
    np.testing.assert_array_equal(w, want)
    assert w.dtype == np.float32 and w.shape == (2 * N_BLOCKS * 128, 16)


def test_probe_inputs_in_the_probes_ranges(probe_inputs):
    tbl, _, state = probe_inputs
    assert tbl.shape == (N_BLOCKS * 128, 16) and tbl.dtype == np.float32
    np.testing.assert_array_equal(tbl[0, :7], [0, -1000, 0, 0, 0, 0, 1000])
    assert (0.15 <= tbl[1:, 6]).all() and (tbl[1:, 6] < 0.25).all()
    assert state.shape == (7, N_TILES * 8, 128)
    assert (0 <= state[1]).all() and (state[1] < 3).all()


@pytest.mark.parametrize("kind", mxu_probe.KINDS)
def test_probe_matches_jax(jax_probe, probe_inputs, kind):
    tbl, w, state = probe_inputs
    fn = jax_probe._build(kind, N_BLOCKS, ITERS, N_TILES, interpret=True)
    want = np.asarray(fn(jnp.asarray(tbl), jnp.asarray(w),
                         jnp.asarray(state)))
    before = mxu_probe.probe.launches
    got = mxu_probe.probe(kind, *map(torch.from_numpy, probe_inputs),
                          n_blocks=N_BLOCKS, iters=ITERS).numpy()
    assert mxu_probe.probe.launches == before  # the plain version
    assert got.shape == want.shape == (N_TILES * 8, 128)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert np.mean(rel > 1e-5) <= 0.01
    assert rel.max() <= 1e-3


def test_probe_kinds_agree_as_the_probe_reports(probe_inputs):
    """The matrix forms against "vpu" on the plain version: the numbers
    ``main`` prints.  The fetch by product is exact, so "mxu_f" equals
    "vpu"; the matrix form's cancellation leaves most lanes equal."""
    args = tuple(map(torch.from_numpy, probe_inputs))
    out = {k: mxu_probe.probe(k, *args, n_blocks=N_BLOCKS,
                              iters=ITERS).numpy()
           for k in mxu_probe.KINDS}
    np.testing.assert_array_equal(out["mxu_f"], out["vpu"])
    np.testing.assert_array_equal(out["mxu_b"], out["mxu"])
    _mx, _rel, share = mxu_probe.compare(out["mxu"], out["vpu"])
    assert share <= 0.05


def test_probe_wrapper_checks_inputs(probe_inputs):
    tbl, w, state = map(torch.from_numpy, probe_inputs)
    with pytest.raises(ValueError, match="kind"):
        mxu_probe.probe("tpu", tbl, w, state, n_blocks=N_BLOCKS, iters=1)
    with pytest.raises(ValueError, match="probe inputs"):
        mxu_probe.probe("vpu", tbl, w, state, n_blocks=3, iters=1)
    with pytest.raises(ValueError, match="probe inputs"):
        mxu_probe.probe("vpu", tbl, w, state[:, :4], n_blocks=N_BLOCKS,
                        iters=1)
    with pytest.raises(ValueError, match="no probe kernel"):
        mxu_probe.probe("vpu", tbl.to("meta"), w.to("meta"),
                        state.to("meta"), n_blocks=N_BLOCKS, iters=1)


def test_probe_main_on_cpu(capsys):
    assert mxu_probe.main(["2", "1", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out[:4]] == list(mxu_probe.KINDS)
    assert all("Gpairs/s" in ln for ln in out[:4])
    assert [ln.split()[0] for ln in out[4:]] == ["mxu", "mxu_b", "mxu_f"]


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("nb", [4, 64])
def test_nb_slice_matches_jax(jax_repro, nb, width):
    ones = np.ones((nb, 16, width), np.float32)
    rand = np.random.default_rng(nb + width).random((nb, 16, width),
                                                    dtype=np.float32)
    for tbl, rtol in ((ones, 0.0), (rand, 1e-5)):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_repro.make_kernel(nb, width)(
                jnp.asarray(tbl)))
        got = repro_nb_slice.nb_slice(torch.from_numpy(tbl)).numpy()
        assert got.shape == want.shape == (8, 128)
        assert (got == got[0, 0]).all()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)
    assert float(got[0, 0]) == pytest.approx(
        float(rand[:, :, :128].astype(np.float64).sum()), rel=1e-5)


def test_nb_slice_wrapper_and_main(capsys):
    with pytest.raises(ValueError, match="table"):
        repro_nb_slice.nb_slice(torch.ones((4, 16, 64)))
    with pytest.raises(ValueError, match="table"):
        repro_nb_slice.nb_slice(torch.ones((4, 8, 128)))
    with pytest.raises(ValueError, match="no nb_slice kernel"):
        repro_nb_slice.nb_slice(torch.ones((4, 16, 128), device="meta"))
    before = repro_nb_slice.nb_slice.launches
    assert repro_nb_slice.main(["3", "5", "--device", "cpu"]) == 0
    assert repro_nb_slice.nb_slice.launches == before
    out = capsys.readouterr().out.splitlines()
    assert out == [f"(NB={nb:5d}, 16, {w}): OK " for w in (128, 256)
                   for nb in (3, 5)]
    assert repro_nb_slice.partial_ctas(1408) == 264
    assert repro_nb_slice.partial_ctas(100) == 100


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("nb", [1, 300, 1408])
def test_nb_slice_kernel_order_matches_jax(jax_repro, nb, width):
    """``nb_slice_ordered``, the kernel's order of the sums (the oracle
    the card holds the kernel to bit for bit), against the JAX kernel:
    exact on ones, within 1e-5 relative on uniform data."""
    ones = np.ones((nb, 16, width), np.float32)
    rand = np.random.default_rng(nb * width).random((nb, 16, width),
                                                    dtype=np.float32)
    for tbl, rtol in ((ones, 0.0), (rand, 1e-5)):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_repro.make_kernel(nb, width)(
                jnp.asarray(tbl)))
        got = repro_nb_slice.nb_slice_ordered(torch.from_numpy(tbl)).numpy()
        assert got.shape == (8, 128) and (got == got[0, 0]).all()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def test_time_t2_needs_a_card():
    """``python -m rtow_tpu_torch.time_t2`` times T2 on the card only."""
    from rtow_tpu_torch import time_t2

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        time_t2.main(["--runs", "1"])


def test_ptxas_report_reads_registers_and_spills():
    """``ptxas_report.entries`` on a ptxas verbose report: each entry's
    registers, spill stores and loads, the anonymous namespace's hash
    taken out of its name."""
    from rtow_tpu_torch import ptxas_report

    log = "\n".join([
        "ptxas info    : 24 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN44_GLOBAL__N__47293412_11_k_cu_1a2b3c4fooEv' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN44_GLOBAL__N__47293412_11_k_cu_1a2b3c4fooEv",
        "    88 bytes stack frame, 56 bytes spill stores, 60 bytes spill "
        "loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN44_GLOBAL__N__47293412_11_k_cu_1a2b3c3barEv' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN44_GLOBAL__N__47293412_11_k_cu_1a2b3c3barEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers",
    ])
    assert ptxas_report.entries(log) == {
        "_ZN44_11_k_cu_1a2b3c4fooEv": [80, 56, 60],
        "_ZN44_11_k_cu_1a2b3c3barEv": [32, 0, 0]}
    with pytest.raises(SystemExit):
        ptxas_report.main(["no-such-source"])
