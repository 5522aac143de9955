"""The full-width LlamaGen VQ-16 codec on the card against the same
module on the CPU. Skips where CUDA is absent. This file imports no JAX,
so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_codec_cuda.py

At 64 px (a 4 x 4 grid, every channel width of VQConfig()), in true fp32
(TF32 off for cuDNN and cuBLAS during the test): encoder latents and
decoded pixels within atol 1e-4 / rtol 1e-3, the bound the JAX package's
own torch-mirror test uses; ids equal wherever the CPU's top-2 margin
exceeds 1e-4 (a smaller margin can flip under another summation order).
"""

import copy

import pytest
import torch

from unidisc_tpu_torch.tokenizers.vqgan import VQConfig, VQGAN

ATOL, RTOL, MARGIN = 1e-4, 1e-3, 1e-4


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def top2_margin(model, z):
    """The CPU's gap between the best and second-best code of each
    latent, in quantize's units."""
    cb = model._codes()
    d = z.shape[1]
    zf = z.permute(0, 2, 3, 1).reshape(-1, d)
    zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    logits = 2.0 * (zf @ cb.T) - (cb ** 2).sum(-1)
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).reshape(z.shape[0], -1)


@pytest.mark.cuda
def test_vq16_on_the_card_matches_the_cpu():
    needs_card()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = VQGAN(VQConfig(), torch.Generator().manual_seed(0)).eval()
        card = copy.deepcopy(cpu).to("cuda")
        gen = torch.Generator().manual_seed(1)
        imgs = torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
        with torch.no_grad():
            z_cpu = cpu.latents(imgs)
            z_card = card.latents(imgs.cuda())
            ids_cpu = cpu.quantize(z_cpu).reshape(2, -1)
            ids_card = card.quantize(z_card).reshape(2, -1).cpu()
            rec_cpu = cpu.decode(ids_cpu)
            rec_card = card.decode(ids_cpu.cuda()).cpu()
            margin = top2_margin(cpu, z_cpu)
        torch.testing.assert_close(z_card.cpu(), z_cpu, atol=ATOL, rtol=RTOL)
        clear = margin > MARGIN
        assert clear.float().mean() > 0.9
        assert torch.equal(ids_card[clear], ids_cpu[clear])
        torch.testing.assert_close(rec_card, rec_cpu, atol=ATOL, rtol=RTOL)
        assert rec_card.shape == (2, 64, 64, 3)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
