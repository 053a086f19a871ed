"""tripled_tpu_torch's fused min-reprojection against the JAX package's
Pallas kernel run in interpret mode (as tests/test_pallas_photometric.py
runs it), on the same numpy inputs. On the CPU the port takes the plain
version of its CUDA kernels; tests/test_torch_port_cuda.py holds the
kernels themselves against it on the card.

Tolerances: forward 1e-5 abs and gradients 1e-4 rel, float32 rounding of
sums taken in another order. bf16 gradients: the Pallas kernel rounds its
gradient tiles to bf16 and folds the reflect padding in bf16, the port
rounds once at the end; 6e-3 abs as in the JAX package's own bf16 test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.ops.pallas.photometric import fused_min_reprojection as jax_fused
from tripled_tpu_torch.ops import photometric
from tripled_tpu_torch.ops.photometric import fused_min_reprojection
from tripled_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


def _inputs(rng, shape, dtype=np.float32):
    B, K, H, W, C = shape
    return rng.rand(B, H, W, C).astype(dtype), rng.rand(B, K, H, W, C).astype(dtype)


def _port_grads(target, preds, grad_ks=None, need_target_grad=True, dtype=torch.float32):
    t = torch.tensor(target, dtype=dtype, requires_grad=True)
    p = torch.tensor(preds, dtype=dtype, requires_grad=True)
    out, idx = fused_min_reprojection(t, p, grad_ks, need_target_grad)
    (out * torch.cos(out)).sum().backward()
    return out, idx, t.grad, p.grad


def _jax_grads(target, preds, grad_ks=None, need_target_grad=True):
    def loss(t, p):
        out, _ = jax_fused(t, p, 8, True, grad_ks, need_target_grad)
        return (out * jnp.cos(out)).sum()

    return jax.grad(loss, argnums=(0, 1))(target, preds)


@pytest.mark.parametrize("shape", [(2, 3, 16, 32, 3), (1, 4, 24, 40, 3)])
def test_forward_matches_pallas(shape, rng_np):
    target, preds = _inputs(rng_np, shape)
    ref_out, ref_idx = jax_fused(target, preds, 8, True)
    out, idx = fused_min_reprojection(torch.from_numpy(target), torch.from_numpy(preds))
    assert out.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("grad_ks,need_target_grad", [(None, True), ((2, 3), False)])
def test_backward_matches_pallas(grad_ks, need_target_grad, rng_np):
    target, preds = _inputs(rng_np, (1, 4, 16, 32, 3))
    jt, jp = _jax_grads(target, preds, grad_ks, need_target_grad)
    _, _, tt, tp = _port_grads(target, preds, grad_ks, need_target_grad)
    scale = np.abs(np.asarray(jp)).max()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4 * scale)
    if need_target_grad:
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4 * scale)
    else:
        # JAX returns zeros; the port gives no gradient, autograd's zero
        assert tt is None and not np.asarray(jt).any()
    if grad_ks is not None:
        assert (tp[:, :2] == 0).all()
        assert tp[:, 2:].abs().max() > 0


def test_static_frame_tiebreak(rng_np):
    """An exact tie between an identity candidate and a warped one keeps
    the identity candidate (listed first), and the warped one gets no
    gradient."""
    target = rng_np.rand(1, 16, 32, 3).astype(np.float32)
    src = rng_np.rand(1, 16, 32, 3).astype(np.float32)
    preds = np.stack([src, src], axis=1)
    _, idx, _, dp = _port_grads(target, preds, grad_ks=(1,), need_target_grad=False)
    assert (idx == 0).all()
    assert (dp == 0).all()
    _, jidx = jax_fused(target, preds, 8, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_bf16_inputs(rng_np):
    target, preds = _inputs(rng_np, (1, 4, 24, 32, 3))
    t16 = jnp.asarray(target, jnp.bfloat16)
    p16 = jnp.asarray(preds, jnp.bfloat16)
    ref_out, ref_idx = jax_fused(t16, p16, 8, True)
    jt, jp = _jax_grads(t16, p16, (2, 3), False)
    # the same bf16 values on both sides
    out, idx, tt, tp = _port_grads(np.asarray(t16, np.float32), np.asarray(p16, np.float32),
                                   (2, 3), False, dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and tp.dtype == torch.bfloat16 and tt is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(tp.float().numpy(), np.asarray(jp, np.float32), rtol=0, atol=6e-3)
    assert (tp[:, :2] == 0).all() and not np.asarray(jt).any()


def test_missing_nvcc_raises(monkeypatch):
    """No nvcc means an error that says so, never a silent fallback."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR / "absent")
    monkeypatch.setattr(photometric, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        photometric.load_library()


def test_kernel_wrappers_refuse_cpu_tensors(rng_np):
    target, preds = _inputs(rng_np, (1, 2, 8, 8, 3))
    t, p = torch.from_numpy(target), torch.from_numpy(preds)
    with pytest.raises(ValueError):
        photometric.fwd_kernel(t, p)
    with pytest.raises(ValueError):
        photometric.fwd_kernel(t, p[:, :, :4])


def test_kernel_wrappers_refuse_more_than_31_candidates():
    """The kernels carry the candidate set as a 32-bit mask: K = 32 is refused
    by the argument checks, before the device is looked at."""
    t, p = torch.zeros((1, 2, 2, 1)), torch.zeros((1, 32, 2, 2, 1))
    g, idx = torch.zeros((1, 2, 2)), torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="K <= 31"):
        photometric.bwd_kernel(t, p, g, idx, (31,), False)
    with pytest.raises(ValueError, match="K <= 31"):
        photometric.fwd_kernel(t, p)
