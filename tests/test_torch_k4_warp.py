"""K4's warp form on the CPU: the forward bounce under the ``Warp`` sweep
policy against the serial one, lane by lane.

K4's triangle instances run one warp per live lane where a launch has few
live lanes (``csrc/grad_fwd.cu``'s ``grad_fwd_warp``): the 32 threads run
the lane's bounce together, its main and shadow sweeps by
``nearest_triangle_warp``, the rest on the same inputs, lane 0 alone
writing.  ``csrc/host_lanes.cpp``'s ``rtow_host_fwd_by`` builds
``bounce_lane_t`` under either policy for the host (g++ ``-O2 -std=c++17
-ffp-contract=off``), the warp's 32 lanes played one after another in one
thread.  The two forms must agree bit for bit on every lane's outputs (the
13 floats, the alive code, the bounce count, the lane id) and on the
counters (box tests, triangle tests, live lanes, shadow rays): the warp
sweep finds the serial sweep's winner, so every decision is the same.  The
tests skip only where there is no g++.

The tapes are ``tests/test_torch_k5_warp.py``'s: the 65,536-triangle knot
in the gradient path's Morton table (down its hyper-blocks) and the
4,096-triangle knot with every triangle twice (exact ties, which the lower
row must win), each unlit under the sky and lit by two square lamps on
black with NEE (shadow sweeps through the hierarchy); every bounce's input
state of one forward from the camera's rays.  One-sided triangles are
K4's; two-sided ones are what K3's lit warp form runs through the same
lane code (``flat_bounce_warp<kLit, true>``).
"""
import ctypes
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_k5_warp import SIZE, SPP, _case  # noqa: E402
from test_torch_lanes_host import build_host_lanes  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the host lanes")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_host_lanes(tmp_path_factory.mktemp("host_lanes"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tri = [p, p, p, p, i, i, i, i, i]
    lib.rtow_host_fwd_by.argtypes = [p, i, *tri, p, p, i, i, i, i, i, f, f,
                                     f, p, p, p, p, i, i, i, i, i, i, i, i,
                                     i]
    return lib


def _fwd(host, case, b, warp, cull):
    """(cont_out, ints_out, counters) of tape entry ``b`` in one form."""
    cont, ints, _cot, it = case.tape[b]
    tris, scalars = case._args(it)
    co, io = torch.empty_like(cont), torch.empty_like(ints)
    stats = (ctypes.c_ulonglong * 4)()
    host.rtow_host_fwd_by(case.tbl.data_ptr(), case.tbl.shape[0], *tris,
                          cont.data_ptr(), ints.data_ptr(), cont.shape[1],
                          *scalars, co.data_ptr(), io.data_ptr(), stats,
                          *case._lit_args(), int(warp), int(cull))
    return co, io, list(stats)


@pytest.mark.parametrize("cull", [True, False], ids=["one", "two"])
@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
@pytest.mark.parametrize("table", ["hypers", "twins"])
def test_warp_forward_bit_identical_to_thread(host, table, lit, cull):
    case = _case(host, table, lit)
    live = shadows = boxes = 0
    for b in range(len(case.tape)):
        t_c, t_i, t_n = _fwd(host, case, b, False, cull)
        w_c, w_i, w_n = _fwd(host, case, b, True, cull)
        assert torch.equal(w_c.view(torch.int32), t_c.view(torch.int32)), b
        assert torch.equal(w_i, t_i), b
        assert w_n == t_n, (b, w_n, t_n)
        live += t_n[2]
        boxes += t_n[0]
        shadows += t_n[3]
    # The tape reaches the table: live lanes that test boxes, and with the
    # lamps shadow rays.
    assert live > SIZE * SIZE * SPP and boxes > live
    assert (shadows > 0) == lit
    # The forms' outputs are the lanes' next states (the tape's own chain
    # is K4's thread form on one-sided triangles).
    if cull:
        for b in range(len(case.tape) - 1):
            t_c, t_i, _ = _fwd(host, case, b, True, cull)
            n_c, n_i, _n_cot, _it = case.tape[b + 1]
            assert torch.equal(t_c, n_c) and torch.equal(t_i, n_i), b

