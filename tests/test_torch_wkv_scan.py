"""The WKV scan's chunk recurrence (``repro_torch.kernels.wkv_scan``) on the
CPU: the plain forward and backward behind ``StateScan`` against autograd
through the loop the model ran before (``ref.state_scan_ref``), a float64
``gradcheck`` of the ``Function``, the ``meta`` route's shapes and work
report, and the checks of the kernel route that a ``meta`` tensor reaches.
The kernels themselves run in ``tests/test_torch_kernels_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import work
from repro_torch.kernels.wkv_scan import ops
from repro_torch.kernels.wkv_scan.ref import state_scan_ref


def _inputs(N, B=2, H=3, K=4, V=8, dtype=torch.float32, device="cpu",
            seed=0):
    """Decays in (0, 1], ``add`` and a non-zero ``s0``."""
    g = torch.Generator().manual_seed(seed)
    decay = 1.0 - torch.rand((N, B, H, K), generator=g, dtype=dtype)
    add = torch.randn((N, B, H, K, V), generator=g, dtype=dtype)
    s0 = 0.5 * torch.randn((B, H, K, V), generator=g, dtype=dtype)
    return tuple(t.to(device) for t in (decay, add, s0))


def _grads(fn, args, cot_entering, cot_final):
    """The outputs of ``fn(*args)`` and the gradients of every input for
    the cotangents given (None: that output does not reach the loss)."""
    args = [a.detach().requires_grad_() for a in args]
    entering, final = fn(*args)
    loss = 0.0
    if cot_entering is not None:
        loss = loss + (entering * cot_entering).sum()
    if cot_final is not None:
        loss = loss + (final * cot_final).sum()
    grads = torch.autograd.grad(loss, args, allow_unused=True)
    # N = 1 with the loss on entering alone leaves decay out of the loop's
    # graph: a zero gradient
    return (entering, final), tuple(torch.zeros_like(a) if d is None else d
                                    for a, d in zip(args, grads))


@pytest.mark.parametrize("N", [1, 5])
@pytest.mark.parametrize("reach", ["both", "entering", "final"])
def test_plain_forward_and_backward_equal_autograd_through_the_loop(N,
                                                                    reach):
    """``reach``: which outputs the loss reads (``final`` alone hands the
    backward ``d_entering`` None; ``entering`` alone ``d_final`` None)."""
    args = _inputs(N)
    g = torch.Generator().manual_seed(1)
    cot_e = torch.randn(args[1].shape, generator=g)
    cot_f = torch.randn(args[2].shape, generator=g)
    cot_e = None if reach == "final" else cot_e
    cot_f = None if reach == "entering" else cot_f
    got, dgot = _grads(ops.state_scan, args, cot_e, cot_f)
    want, dwant = _grads(state_scan_ref, args, cot_e, cot_f)
    for a, b in zip(got + dgot, want + dwant):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_function_gradcheck_float64():
    args = [a.requires_grad_() for a in _inputs(3, 1, 2, 2, 4,
                                                dtype=torch.float64)]
    assert torch.autograd.gradcheck(ops.StateScan.apply, args)


@pytest.mark.parametrize("s0_grad", [False, True])
def test_d_s0_only_when_asked(monkeypatch, s0_grad):
    """The backward asks ``scan_bwd`` for ``d_s0`` only when ``s0`` needs a
    gradient, and ``scan_bwd`` then returns None for it."""
    asked = []
    real = ops.scan_bwd

    def bwd(*a, d_s0):
        asked.append(d_s0)
        return real(*a, d_s0=d_s0)

    monkeypatch.setattr(ops, "scan_bwd", bwd)
    decay, add, s0 = (t.requires_grad_() for t in _inputs(4))
    s0.requires_grad_(s0_grad)
    entering, final = ops.state_scan(decay, add, s0)
    grads = torch.autograd.grad(final.sum() + entering.sum(),
                                [decay, add] + ([s0] if s0_grad else []))
    assert asked == [s0_grad] and len(grads) == 2 + s0_grad
    assert real(decay.detach(), entering.detach(), torch.ones_like(entering),
                None, d_s0=False)[2] is None


class _Counter:
    hidden = 0

    def __init__(self):
        self.calls = []

    def kernel(self, name, ops_, nbytes):
        self.calls.append((name, ops_, nbytes, self.hidden))


def test_meta_route_shapes_and_work_report():
    N, B, H, K, V = 256, 4, 40, 64, 64
    decay, add, s0 = (torch.empty(s, device="meta", requires_grad=True)
                      for s in ((N, B, H, K), (N, B, H, K, V), (B, H, K, V)))
    with work.active(_Counter()) as c:
        entering, final = ops.state_scan(decay, add, s0)
        assert entering.shape == (N, B, H, K, V) and final.shape == s0.shape
        assert entering.is_meta and final.is_meta
        grads = torch.autograd.grad((entering.sum(), final.sum()),
                                    [decay, add, s0])
    assert [t.shape for t in grads] == [decay.shape, add.shape, s0.shape]
    assert c.calls == [
        ("wkv_state_fwd", *ops.scan_fwd_work(N, B, H, K, V), 0),
        ("wkv_state_bwd", *ops.scan_bwd_work(N, B, H, K, V, True), 0)]
    # at the training shape: 1.34 GB forward, 2.04 GB backward
    R = B * H * K
    assert c.calls[0][2] == 4.0 * (2 * N * R * V + N * R + 2 * R * V)
    assert c.calls[1][2] == 4.0 * (3 * N * R * V + 2 * N * R + 2 * R * V)
    assert ops.scan_fwd.launches == ops.scan_bwd.launches == 0


def test_cpu_route_reports_and_hides_its_plain_ops(monkeypatch):
    """The CPU route reports the kernel's work, then runs the plain
    version inside ``work.plain_version`` (the counter's ``hidden``)."""
    c, hidden = _Counter(), []
    real = ops.scan_fwd_plain

    def plain(*a):
        hidden.append(c.hidden)
        return real(*a)

    monkeypatch.setattr(ops, "scan_fwd_plain", plain)
    with work.active(c):
        ops.scan_fwd(*_inputs(3))
    assert [k[0] for k in c.calls] == ["wkv_state_fwd"] and hidden == [1]


@pytest.mark.parametrize("bad", ["float64", "V12", "strided", "shape",
                                 "empty"])
def test_kernel_route_refuses_what_the_kernels_do_not_take(bad):
    """On ``meta`` tensors, which take the kernel route's checks."""
    N, B, H, K, V = 3, 1, 2, 4, 8
    shapes = [(N, B, H, K), (N, B, H, K, V), (B, H, K, V)]
    dtype = torch.float64 if bad == "float64" else torch.float32
    if bad == "V12":
        shapes = [(N, B, H, K), (N, B, H, K, 12), (B, H, K, 12)]
    if bad == "shape":
        shapes[0] = (N, B, H, K + 1)
    if bad == "empty":
        shapes = [(0,) + s[1:] for s in shapes[:2]] + [shapes[2]]
    decay, add, s0 = (torch.empty(s, device="meta", dtype=dtype)
                      for s in shapes)
    if bad == "strided":
        add = torch.empty((N, B, H, V, K), device="meta").transpose(-1, -2)
    with pytest.raises(ValueError):
        ops.state_scan(decay, add, s0)


def test_cpu_route_takes_any_v_and_refuses_bad_shapes():
    decay, add, s0 = _inputs(2, V=3)
    entering, final = ops.state_scan(decay, add, s0)
    want = state_scan_ref(decay, add, s0)
    torch.testing.assert_close(entering, want[0])
    torch.testing.assert_close(final, want[1])
    with pytest.raises(ValueError, match="state_scan takes"):
        ops.state_scan(decay, add, s0[0])
