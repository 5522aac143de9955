"""How closely int8 W8A8 logits track the bf16 model at the flagship
width, in the JAX package and in the PyTorch port, at the same weights.

    JAX_PLATFORMS=cpu python scripts/port_int8_top1.py [--rows 2] [--seed 0]

Draws the flagship serving model's weights with the port's ``randomize_``
(full width and depth, bf16 logits), carries them into the JAX tree with
``unidisc_tpu.models.port.port_dit_state_dict``, quantizes each side with
its own ``quantize_dit_params``/``quantize_model`` (the fused prologue, the
plain products) and prints, as one JSON line, the top-1 agreement of each
side's int8 logits with its own bf16 logits over all positions, and over
the positions whose bf16 lead (best minus second logit) exceeds twice the
mean |int8 - bf16| difference. Runs on the CPU; plain attention on both
sides.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.models.port import port_dit_state_dict
from unidisc_tpu.ops.quant import quantize_dit_params
from unidisc_tpu_torch.config import (FLAGSHIP_INT8_OVERRIDES,
                                      FLAGSHIP_OVERRIDES, Config)
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops.quant import quantize_model


def agreement(q, ref):
    """Top-1 agreement of `q` with `ref`, overall and where ref's lead is
    clear (more than twice the mean |q - ref|)."""
    best2 = np.sort(ref, -1)[..., -2:]
    clear = best2[..., 1] - best2[..., 0] > 2 * np.abs(q - ref).mean()
    same = q.argmax(-1) == ref.argmax(-1)
    return {"top1": float(same.mean()), "top1_clear": float(same[clear].mean()),
            "share_clear": float(clear.mean()),
            "median_lead": float(np.median(best2[..., 1] - best2[..., 0]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    over = {**FLAGSHIP_OVERRIDES, "model.attn_backend": "xla"}
    cfg, jcfg = Config.make("small", **over), JaxConfig.make("small", **over)
    m = cfg.model
    model = DIT(m, compute_dtype=torch.bfloat16).eval()
    randomize_(model, args.seed)
    _, template = init_dit(jax.random.PRNGKey(0), jcfg.model)
    params = port_dit_state_dict(
        template, {k: v.numpy() for k, v in model.state_dict().items()})

    rng = np.random.RandomState(args.seed)
    b, lt, li = args.rows, m.txt_length, m.img_length
    img = rng.randint(0, m.image_vocab_size, (b, li)) + m.text_vocab_size
    x = np.concatenate([rng.randint(0, m.text_vocab_size, (b, lt)),
                        np.where(rng.rand(b, li) < 0.5, m.mask_index, img)],
                       1).astype(np.int32)
    modality = np.concatenate([np.zeros((b, lt)), np.ones((b, li))],
                              1).astype(np.int32)
    sigma = rng.uniform(0.05, 3.0, b).astype(np.float32)

    def jax_logits(model_cfg, tree):
        fn = jax.jit(lambda p: JaxDIT(model_cfg).apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(sigma),
            modality=jnp.asarray(modality)))
        return np.asarray(fn(tree), np.float32)

    jq = dataclasses.replace(jcfg.model, quant="int8", quant_fused=True)
    j_bf16 = jax_logits(jcfg.model, params)
    j_int8 = jax_logits(jq, quantize_dit_params(params))

    qcfg = Config.make("small", **{**FLAGSHIP_INT8_OVERRIDES,
                                   "model.attn_backend": "xla"})
    _, qmodel = quantize_model(qcfg, model)
    with torch.no_grad():
        t_args = (torch.from_numpy(x).long(), torch.from_numpy(sigma))
        mod = torch.from_numpy(modality).long()
        t_bf16 = model(*t_args, modality=mod).float().numpy()
        t_int8 = qmodel(*t_args, modality=mod).float().numpy()
    print(json.dumps({"rows": b, "seed": args.seed,
                      "jax_int8_vs_jax_bf16": agreement(j_int8, j_bf16),
                      "port_int8_vs_port_bf16": agreement(t_int8, t_bf16),
                      "port_int8_vs_jax_int8_top1": float(
                          (t_int8.argmax(-1) == j_int8.argmax(-1)).mean())}))


if __name__ == "__main__":
    main()
