"""The WKV6 backward's plain version (``wkv6_bwd_ref``, the reverse
recurrence the CUDA kernel ``wkv6_bwd.cu`` computes) on the CPU: against
torch autograd of ``wkv6_ref`` in float64, against ``jax.vjp`` of the JAX
package's ``wkv6_scan`` with ``use_pallas=False`` (its plain checkpointed
scan, the route the JAX train step takes), and the wrapper's autograd
Function with the plain versions in place of the kernels.

Inputs are made with numpy from a seed: r, v N(0, 1), k N(0, 0.3^2), u
N(0, 0.1^2), the state N(0, 0.5^2), the decays in [0.45, 0.95] as the JAX
package's WKV6 tests draw them or as the model draws them (exp(-exp(x))
rounded to bfloat16, with exact zeros and ones planted).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrw
from repro_torch.kernels import wkv6, wkv6_backward
from repro_torch.kernels.rwkv6_wkv import ops, wkv6_bwd_ref, wkv6_ref
from repro_torch.kernels.rwkv6_wkv.ref import BWD_REF_SPAN

torch.set_num_threads(2)

NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def inputs(seed, b, t, h, kk, decays="tests", nonzero=True):
    """float64 numpy arrays r, k, v, w, u, s0, dy, dstate_out (the last
    two None-free; dstate_out zero unless ``nonzero``)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale
    r, k, v = normal(b, t, h, kk), normal(b, t, h, kk, scale=0.3), normal(b, t, h, kk)
    if decays == "model":
        x = rng.uniform(-6, 4, (b, t, h, kk)).astype(np.float32)
        w = torch.from_numpy(np.exp(-np.exp(x))).bfloat16().double().numpy()
        pick = rng.random((b, t, h, kk))
        w = np.where(pick < 0.02, 0.0, np.where(pick > 0.98, 1.0, w))
    else:
        w = 1.0 / (1.0 + np.exp(-normal(b, t, h, kk))) * 0.5 + 0.45
    u = normal(h, kk, scale=0.1)
    s0 = normal(b, h, kk, kk, scale=0.5) if nonzero else np.zeros((b, h, kk, kk))
    dy = normal(b, t, h, kk)
    ds = normal(b, h, kk, kk) if nonzero else np.zeros((b, h, kk, kk))
    return r, k, v, w, u, s0, dy, ds


def autograd_grads(r, k, v, w, u, s0, dy, ds):
    """Autograd of ``wkv6_ref`` for the cotangents (dy, ds), in the inputs'
    type (float64 here)."""
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv6_ref(*leaves)
    return torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)


def assert_within(ours, want, rtol, atol, share):
    """Element by element: |a - b| <= rtol |b| + atol + share max|b| for
    each of the six gradients (a, b as float64)."""
    for name, a, b in zip(NAMES, ours, want):
        a, b = a.double(), b.double()
        assert bool(torch.isfinite(a).all()), name
        limit = rtol * b.abs() + atol + share * b.abs().max()
        worst = float(((a - b).abs() / limit.clamp_min(1e-300)).max())
        assert worst <= 1.0, f"{name}: {worst:.3g} of the limit"


#: (B, T, H, K, decays, nonzero initial state and dstate_out): one step; T
#: past one span of BWD_REF_SPAN and not a multiple of it; K 32 and 64; the
#: model's decays with exact zeros and ones; zero state and no dstate_out.
REF_CASES = [
    (2, 1, 3, 32, "tests", True),
    (2, BWD_REF_SPAN + 6, 3, 32, "tests", True),
    (1, 2 * BWD_REF_SPAN + 3, 2, 64, "tests", True),
    (2, 70, 2, 64, "model", True),
    (2, 40, 2, 32, "model", False),
    (1, 17, 4, 64, "tests", False),
]


@pytest.mark.parametrize("b,t,h,kk,decays,nonzero", REF_CASES)
def test_bwd_ref_matches_float64_autograd_of_the_forward(b, t, h, kk, decays, nonzero):
    """In float64 the reverse recurrence and autograd of the forward loop
    agree to rounding (1e-12 of each gradient's largest element)."""
    xs = [torch.from_numpy(x) for x in inputs(t + kk, b, t, h, kk, decays, nonzero)]
    if decays == "model":
        assert int((xs[3] == 0).sum()) > 0 and int((xs[3] == 1).sum()) > 0
    want = autograd_grads(*xs)
    ours = wkv6_bwd_ref(*xs)
    assert [g.dtype for g in ours] == [torch.float64] * 6
    assert_within(ours, want, 0.0, 0.0, 1e-12)


#: The kernel's tolerances (tests/test_torch_cuda.py, WKV_BWD_TOL), as
#: (rtol, atol, share): float32 (and dstate at either input type) 2e-5 of
#: the largest element; bfloat16 one bfloat16 step, 2^-7 |b| + 1e-5.  Here
#: against the float64 gradient of the same (exactly widened) inputs.
IN_TYPE_TOL = {torch.float32: (0.0, 0.0, 2e-5), torch.bfloat16: (2 ** -7, 1e-5, 0.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kk,decays,nonzero", REF_CASES[1:4])
def test_bwd_ref_in_the_input_type_meets_the_kernel_limits(b, t, h, kk, decays, nonzero, dtype):
    """float32 and bfloat16 inputs: the reverse recurrence computes in
    float32 and returns each gradient in its input's type, dstate in
    float32, within the limits the kernel is held to of the float64
    gradient."""
    xs = [torch.from_numpy(x) for x in inputs(t * 3 + kk, b, t, h, kk, decays, nonzero)]
    typed = [x.to(dtype) for x in xs[:5]] + [xs[5].float(), xs[6].to(dtype), xs[7].float()]
    ours = wkv6_bwd_ref(*typed)
    assert [g.dtype for g in ours] == [dtype] * 5 + [torch.float32]
    want = autograd_grads(*(x.double() for x in typed))
    assert_within(ours[:5], want[:5], *IN_TYPE_TOL[dtype])
    assert_within(ours[5:], want[5:], *IN_TYPE_TOL[torch.float32])


#: (B, T, H, K, decays): JAX's scan checkpoints chunks of up to 256 steps
#: (T 300 makes it halve to 150), the model's decays at T 33.
JAX_CASES = [(2, 1, 2, 32, "tests"), (2, 33, 3, 32, "model"), (1, 300, 2, 64, "tests"),
             (2, 50, 2, 64, "model")]


@pytest.mark.parametrize("b,t,h,kk,decays", JAX_CASES)
def test_bwd_ref_matches_jax_grad_of_the_plain_scan(b, t, h, kk, decays):
    """Against ``jax.vjp`` of ``repro.models.rwkv6.wkv6_scan(...,
    use_pallas=False)`` with cotangents on y and on the final state, both in
    float32 from the same numpy inputs: every gradient within 2e-5 of its
    largest element (docs/kernels.md's float32 tolerance)."""
    xs = [x.astype(np.float32) for x in inputs(7 * t + kk, b, t, h, kk, decays)]
    r, k, v, w, u, s0, dy, ds = xs

    def scan(r, k, v, w, u, s0):
        return jrw.wkv6_scan(r, k, v, w, u, s0, use_pallas=False)

    _, vjp = jax.vjp(scan, *(jnp.asarray(x) for x in (r, k, v, w, u, s0)))
    want = [torch.from_numpy(np.array(g)) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]
    ours = wkv6_bwd_ref(*(torch.from_numpy(x) for x in xs))
    assert_within(ours, want, 0.0, 0.0, 2e-5)


@pytest.mark.parametrize("use_state", [False, True])
@pytest.mark.parametrize("state_grad", [False, True])
def test_autograd_function_gives_the_plain_gradients(monkeypatch, state_grad, use_state):
    """The wrapper's autograd Function (the card's path) with its forward
    kernel replaced by ``wkv6_ref`` and its backward on the CPU
    (``wkv6_bwd_ref``): autograd's gradients of a loss on y, and on the final
    state or not (a None gradient taken as zero), equal ``wkv6_backward``'s
    and autograd's of the plain loop; the initial state gets a gradient only
    where it asks for one."""
    monkeypatch.setattr(ops, "_forward", wkv6_ref)
    xs = [torch.from_numpy(x).float() for x in inputs(3, 2, 20, 2, 32)]
    dy, ds = xs[6], xs[7] if use_state else torch.zeros_like(xs[7])
    leaves = [x.clone().requires_grad_(i < 5 or state_grad) for i, x in enumerate(xs[:6])]
    y, s = ops._WKV6.apply(*leaves)
    loss = (y * dy).sum() + ((s * ds).sum() if use_state else 0)
    grads = torch.autograd.grad(loss, [x for x in leaves if x.requires_grad])
    assert len(grads) == (6 if state_grad else 5)
    direct = wkv6_backward(*xs[:6], dy, ds if use_state else None)
    for a, b in zip(grads, direct):
        assert torch.equal(a, b)
    plain = autograd_grads(*xs[:6], dy, ds)
    assert_within(grads, plain, 0.0, 0.0, 1e-5)


def test_cpu_wkv6_differentiates_the_plain_loop_and_counts_no_launch():
    """On the CPU ``wkv6`` is ``wkv6_ref`` itself (autograd differentiates
    it) and ``wkv6_backward`` is ``wkv6_bwd_ref``: neither counts a launch."""
    before = (wkv6.launches, wkv6_backward.launches)
    xs = [torch.from_numpy(x).float() for x in inputs(4, 1, 9, 2, 32)]
    leaves = [x.clone().requires_grad_() for x in xs[:6]]
    y, _ = wkv6(*leaves)
    assert y.grad_fn is not None and "WKV6" not in type(y.grad_fn).__name__
    grads = torch.autograd.grad((y * xs[6]).sum(), leaves)
    for a, b in zip(grads, wkv6_backward(*xs[:7])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert (wkv6.launches, wkv6_backward.launches) == before
