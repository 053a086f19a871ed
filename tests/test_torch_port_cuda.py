"""tripled_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card. Every test here needs a CUDA device and skips without one.
The file imports no JAX, so that it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, as in chip_smoke.py: forward 1e-5 abs and argmin agreement
>= 0.9999 (float32 arithmetic on both sides, in another order); gradients 1e-4 of the largest
gradient in float32, 8e-3 in bf16, where the kernel rounds its output once
to bf16 (2^-8 relative).
"""

import pytest
import torch

from tripled_tpu_torch.ops import photometric


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 37, 53, 3), (1, 2, 2, 5, 3), (1, 3, 3, 2, 1),
                                   (12, 4, 192, 640, 3)])
def test_kernels_match_plain(shape, dtype, cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(0)
    B, K, H, W, C = shape
    t = torch.rand((B, H, W, C), generator=gen, device=cuda_device).to(dtype)
    p = torch.rand((B, K, H, W, C), generator=gen, device=cuda_device).to(dtype)
    out, idx = photometric.fwd_kernel(t, p)
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert (idx == ref_idx).float().mean() >= 0.9999
    g = torch.rand(out.shape, generator=gen, device=cuda_device)
    for grad_ks, need_t in [(tuple(range(K)), True), ((K - 1,), False)]:
        dt, dp = photometric.bwd_kernel(t, p, g, ref_idx, grad_ks, need_t)
        rdt, rdp = photometric.min_reprojection_plain_backward(t, p, g, grad_ks, need_t)
        assert dp.dtype == dtype
        scale = max(rdp.float().abs().max().item(), 1e-12)
        if need_t:
            assert dt.dtype == dtype
            scale = max(scale, rdt.float().abs().max().item())
        else:
            assert dt is None and rdt is None
        tol = 1e-4 if dtype == torch.float32 else 8e-3
        assert (dp.float() - rdp.float()).abs().max().item() / scale <= tol
        if need_t:
            assert (dt.float() - rdt.float()).abs().max().item() / scale <= tol


@pytest.mark.cuda
def test_autograd_binding_on_cuda(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(1)
    t = torch.rand((2, 16, 24, 3), generator=gen, device=cuda_device)
    p = torch.rand((2, 4, 16, 24, 3), generator=gen, device=cuda_device, requires_grad=True)
    before = dict(photometric.launches)
    out, _ = photometric.fused_min_reprojection(t, p, grad_ks=(2, 3), need_target_grad=False)
    out.sum().backward()
    assert photometric.launches["fwd"] == before["fwd"] + 1
    assert photometric.launches["bwd"] == before["bwd"] + 1
    ref, _ = photometric.min_reprojection_plain(t.cpu(), p.detach().cpu())
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)
    assert (p.grad[:, :2] == 0).all()


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(2)
    t = torch.rand((2, 32, 48, 3), generator=gen, device=cuda_device)
    p = torch.rand((2, 4, 32, 48, 3), generator=gen, device=cuda_device)
    out, idx = photometric.fwd_kernel(t, p)
    g = torch.rand(out.shape, generator=gen, device=cuda_device)
    a = photometric.bwd_kernel(t, p, g, idx, (0, 1, 2, 3), True)
    b = photometric.bwd_kernel(t, p, g, idx, (0, 1, 2, 3), True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
