"""Batched serving loop: prefill + decode with a KV cache, greedy sampling
(a port of the reference's `launch/serve.py`).

Serves the dense (qwen2-1.5b, qwen2.5-14b, minitron-8b, gemma3-12b),
moe (qwen2-moe-a2.7b, deepseek-v3-671b: its 61 layers do not fit one
card, `--smoke`), vlm (llava-next-34b), hybrid (zamba2-7b), ssm
(mamba2-1.3b) and audio (whisper-tiny) architectures, with random
parameters from a seed. Usage (on the card;
`--device cpu` runs the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --batch 4 --prompt-len 16 --gen 16
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
             params=None, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None, log=print):
    """Greedy generation of `gen` tokens after a random prompt of
    `prompt_len` tokens per sequence, drawn from
    `np.random.default_rng(seed)` as the reference draws it, and after
    them, from the same generator, N(0, 1) bfloat16 patch embeddings
    (B, n_patches, D) for the VLM family or frame embeddings (B,
    n_audio_frames, D) for the audio family, as the reference draws
    them. `params` is the model's parameters module on `device` (None:
    initialised there from `generator`). Returns (tokens (batch, gen)
    int32 numpy, {"prefill_s", "decode_s"}), the times on the host clock
    after a device synchronise.

    Here the port departs from the reference's `generate`, which sizes
    the cache `prompt_len + gen` and decodes at positions `prompt_len +
    i` for every family: the VLM family's prefill holds the patches
    ahead of the prompt, so that cache is too short (its prefill pads by
    a negative amount and raises) and those positions leave the patches
    out. The port counts them: a cache of `n_patches + prompt_len + gen`
    positions, and decode step i at `n_patches + prompt_len + i`. The
    reference's `prefill_fn` and `decode_fn` agree with the port's at
    that capacity and those positions."""
    dev = resolve(device)
    model = build_model(cfg)
    n_pre = cfg.n_patches if cfg.family == "vlm" else 0
    cap = n_pre + prompt_len + gen
    rng = np.random.default_rng(seed)

    with torch.inference_mode():
        if params is None:
            params = model.init_params(generator=generator, device=dev)
        prompt = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (batch, prompt_len)),
            dtype=torch.int64, device=dev)}
        extra = {"vlm": ("patches", cfg.n_patches),
                 "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
        if extra is not None:
            name, n = extra
            prompt[name] = torch.as_tensor(
                rng.normal(size=(batch, n, cfg.d_model)),
                dtype=torch.float32).to(dev, torch.bfloat16)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompt, cap)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits[..., :cfg.vocab], -1)
        out_tokens = [tok]
        t1 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_fn(params, cache, tok,
                                            n_pre + prompt_len + i)
            tok = torch.argmax(logits[..., :cfg.vocab], -1)
            out_tokens.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t1
        toks = torch.cat(out_tokens, dim=1)
    log(f"[serve] prefill {t_prefill * 1e3:.0f}ms, "
        f"{gen - 1} decode steps {t_decode * 1e3:.0f}ms "
        f"({(gen - 1) * batch / max(t_decode, 1e-9):.1f} tok/s)")
    return toks.cpu().numpy().astype(np.int32), {"prefill_s": t_prefill,
                                                 "decode_s": t_decode}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    toks, stats = generate(cfg, batch=args.batch,
                           prompt_len=args.prompt_len, gen=args.gen,
                           device=args.device)
    print(json.dumps({"shape": list(toks.shape), **stats}))


if __name__ == "__main__":
    main()
