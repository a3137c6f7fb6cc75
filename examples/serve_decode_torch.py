"""Batched serving demo of the PyTorch + CUDA port: prefill + decode.

    PYTHONPATH=src python examples/serve_decode_torch.py \
        [--arch codeqwen1.5-7b] [--batch 4] [--prompt-len 64] [--gen 32]
        [--temperature 0.8] [--device cuda|cpu]

The port's counterpart of ``examples/serve_decode.py``, with its flags
and the reduced configuration: random weights from a seeded generator,
a random prompt, ``transformer.prefill`` then token-by-token
``transformer.decode_step`` with temperature sampling.  Runs on the CUDA
card by default, where every attention layer goes through the
``flash_attention`` kernel; ``--device cpu`` runs its plain version.
Every architecture of the zoo: the dense decoder-only ones
(h2o-danube-3-4b, codeqwen1.5-7b, qwen3-14b, stablelm-12b), the MoE
decoders (mixtral-8x22b, qwen3-moe-235b-a22b: top-k routing and the
capacity dispatch), the Jamba hybrid (jamba-1.5-large-398b: attention,
Mamba states and MoE), xlstm-125m (recurrent states in place of K/V),
the VLM (qwen2-vl-72b: a prompt of random patch embeddings, M-RoPE) and
the encoder-decoder (whisper-small: random frame embeddings through the
encoder, cross-attention K/V kept in the cache), as the JAX example
feeds them.
"""

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.serving_params(transformer.init(gen, cfg), cfg)
    b, s = args.batch, args.prompt_len
    max_len = s + args.gen + 1
    if cfg.input_mode == "embeddings":
        prompt = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    else:
        prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev)
    enc = (torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
           if cfg.is_encdec else None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    logits, cache = transformer.prefill(params, prompt, cfg,
                                        encoder_inputs=enc, pad_to=max_len)
    sync()
    print(f"[serve] {cfg.name}: prefill {b}x{s} in {time.time() - t0:.2f}s "
          f"on {dev}")

    tok = logits[:, -1].argmax(-1)[:, None]
    toks = [tok]
    t0 = time.time()
    for i in range(args.gen):
        logits, cache = transformer.decode_step(params, tok, cache, s + i,
                                                cfg)
        probs = torch.softmax(logits[:, 0].float() / args.temperature, -1)
        tok = torch.multinomial(probs, 1, generator=gen)
        toks.append(tok)
    sync()
    dt = time.time() - t0
    out = torch.cat(toks, dim=1)
    print(f"[serve] generated {args.gen} tokens x {b} seqs in {dt:.2f}s "
          f"({args.gen * b / dt:.1f} tok/s)")
    print("[serve] first sequence:", out[0].tolist())


if __name__ == "__main__":
    main()
