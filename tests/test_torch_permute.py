"""The sorted lanes' permutation (``ops/grad.LanePermute``) on the CPU.

Its forward is ``index_select``'s two gathers; its backward writes each
cotangent column back to its lane once (``index_copy_`` into an empty
tensor).  A permutation moves values and adds none, so the outputs and
the ``cont`` cotangent equal (``torch.equal``) what ``index_select``
and its autograd backward, an accumulating scatter into zeros, give.
The one difference in bits is the sign of a zero: the accumulating
scatter adds -0.0 to +0.0 and keeps +0.0, the un-permute moves -0.0.
"""
import numpy as np
import pytest
import torch

from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad

W = H = 12


def _lanes(n, seed):
    gen = torch.Generator().manual_seed(seed)
    cont = torch.randn((13, n), generator=gen)
    ints = torch.randint(0, 9, (3, n), dtype=torch.int32, generator=gen)
    # Few distinct keys: many ties, broken by the stable sort.
    keys = torch.randint(0, max(n // 64, 2), (n,), generator=gen)
    return cont, ints, torch.argsort(keys, stable=True), gen


@pytest.mark.parametrize("n", [1024, 3072, 8192, 65536])
def test_permute_equals_index_select_and_its_backward(n):
    cont, ints, perm, gen = _lanes(n, n)
    cot = torch.randn((13, n), generator=gen)
    mine = cont.clone().requires_grad_(True)
    ref = cont.clone().requires_grad_(True)
    out, out_ints = grad.permute_lanes(mine, ints, perm)
    ref_out = ref.index_select(1, perm)
    assert torch.equal(out, ref_out)
    assert torch.equal(out_ints, ints.index_select(1, perm))
    g_mine, = torch.autograd.grad(out, mine, cot)
    g_ref, = torch.autograd.grad(ref_out, ref, cot)
    assert torch.equal(g_mine, g_ref)
    # Every column written once: the cotangent of lane perm[j] is cot[:, j].
    assert torch.equal(g_mine[:, perm], cot)


def test_ints_get_no_gradient():
    """``ints`` and ``perm`` carry no cotangent: the permuted ints do not
    require grad, and only ``cont`` is an input of the graph."""
    cont, ints, perm, gen = _lanes(1024, 1)
    cont.requires_grad_(True)
    out, out_ints = grad.permute_lanes(cont, ints, perm)
    assert out.requires_grad and not out_ints.requires_grad
    assert not perm.requires_grad
    (out * torch.randn(out.shape, generator=gen)).sum().backward()
    assert cont.grad is not None and cont.grad.shape == cont.shape


def test_backward_neither_sums_nor_sorts():
    """The un-permute is one write a column: no index_add_, no
    accumulating index_put_, no scatter_add_, no sort, no zero fill."""
    from torch.profiler import ProfilerActivity, profile

    cont, ints, perm, gen = _lanes(4096, 2)
    cont.requires_grad_(True)
    out, _ = grad.permute_lanes(cont, ints, perm)
    cot = torch.randn(out.shape, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(out, cont, cot)
    names = {e.key for e in prof.key_averages()}
    assert "rtow.grad.unpermute" in names and "aten::index_copy_" in names
    banned = {"aten::index_add_", "aten::index_put_", "aten::scatter_add_",
              "aten::sort", "aten::zeros", "aten::zero_", "aten::fill_"}
    assert not names & banned, sorted(names & banned)


def _scene():
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    return b.build(device="cpu")


def _loss_and_grad(depth):
    cam = make_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    pix = torch.arange(W * H)
    return grad.loss_and_grad_kernel(
        _scene(), cam, torch.Generator().manual_seed(0),
        torch.zeros((W * H, 3)), pix, width=W, height=H, spp=4,
        max_depth=depth, sort_lanes=True)


@pytest.mark.parametrize("depth", [1, 3])
def test_sorted_render_counts_its_permutes(depth):
    """A sorted render at depth d permutes d + 2 times (before each of the
    d + 1 bounces, then back to lane order) and un-permutes d + 1
    cotangents: the first permute's lanes are the camera rays, which
    carry no gradient, so autograd never runs its backward."""
    before = (grad.permute_lanes.launches, grad.permute_lanes.bwd_launches)
    _loss_and_grad(depth)
    assert (grad.permute_lanes.launches - before[0],
            grad.permute_lanes.bwd_launches - before[1]) == (depth + 2,
                                                             depth + 1)


def test_sorted_gradient_equals_index_select_backward(monkeypatch):
    """The sorted loss and every scene gradient equal those computed with
    ``index_select``'s own backward in place of the un-permute."""
    loss, grads = _loss_and_grad(3)

    def plain(cont, ints, perm):
        return cont.index_select(1, perm), ints.index_select(1, perm)

    monkeypatch.setattr(grad, "permute_lanes", plain)
    ref_loss, ref_grads = _loss_and_grad(3)
    assert torch.equal(loss, ref_loss)
    for key, g in ref_grads.leaves().items():
        if g is not None:
            assert torch.equal(grads.leaves()[key], g), key
            assert np.isfinite(g.numpy()).all(), key
