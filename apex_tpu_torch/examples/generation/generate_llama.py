"""Autoregressive generation on a tiny Llama: greedy, sampled,
speculative and beam-search decode.

Counterpart of ``examples/generation/generate_llama.py`` of the JAX
package, on one GPU (or the CPU with ``--device cpu``): flash prefill,
single-token steps over the contiguous cache, top-k / top-p sampling with
an int seed (``models/generation.py``), greedy speculative decoding with a
differently seeded draft (its output must equal plain greedy), and beam
search. The reference's tensor-parallel decode is not ported: ``--tp`` above
1 raises (ROADMAP queue A item 10).

Run:  python -m apex_tpu_torch.examples.generation.generate_llama
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from apex_tpu_torch.models import (LlamaModel, generate, generate_beam,
                                   llama_tiny_config, speculative_generate)


def _model(seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return LlamaModel(llama_tiny_config(), device=device,
                      generator=gen).eval()


def _prompt(cfg, prompt_len: int, seed: int, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        2, prompt_len)).astype(np.int32)).to(device)


def run_generation(*, prompt_len=6, new_tokens=12, tp=1, temperature=0.0,
                   top_k=None, top_p=None, seed=0, device="cuda",
                   verbose=print):
    """Greedy or sampled decode on a tiny Llama (GQA + SwiGLU). Returns the
    generated ``(batch, prompt + new)`` tokens."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel decode is not ported yet (ROADMAP queue A "
            "item 10)")
    model = _model(0, device)
    prompt = _prompt(model.config, prompt_len, seed, device)
    sample_kw = (dict(temperature=temperature, top_k=top_k, top_p=top_p,
                      rng=seed) if temperature else {})
    out = generate(model, prompt, new_tokens, **sample_kw).cpu().numpy()
    mode = (f"sampled(T={temperature}, top_k={top_k}, top_p={top_p})"
            if temperature else "greedy")
    verbose(f"[generation] {mode}: prompt {prompt_len} tokens -> "
            f"{out.shape[1]} tokens")
    for row in out:
        verbose(f"  {row.tolist()}")
    return out


def run_speculative(*, prompt_len=6, new_tokens=10, k=4, seed=0,
                    device="cuda", verbose=print):
    """Greedy speculative decoding: a differently seeded tiny draft
    proposes ``k - 1`` tokens a round; the output must equal plain
    greedy."""
    model, draft = _model(0, device), _model(99, device)
    prompt = _prompt(model.config, prompt_len, seed, device)
    ref = generate(model, prompt, new_tokens).cpu().numpy()
    out = speculative_generate(model, draft, prompt, new_tokens,
                               k=k).cpu().numpy()
    if not (out == ref).all():
        raise AssertionError("speculative decoding must equal greedy")
    verbose(f"[speculative] k={k}: exact greedy parity over {new_tokens} "
            f"tokens")
    return out


def run_beam(*, prompt_len=6, new_tokens=8, beams=4, seed=0, device="cuda",
             verbose=print):
    """Beam search with the length penalty off: the best beam's score is
    its sum of log-probabilities."""
    model = _model(0, device)
    prompt = _prompt(model.config, prompt_len, seed, device)
    seqs, scores = generate_beam(model, prompt, new_tokens, num_beams=beams,
                                 length_penalty=0.0)
    seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
    verbose(f"[beam] {beams} beams, best scores: "
            f"{np.round(scores[:, 0], 2).tolist()}")
    return seqs, scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=1)
    args = ap.parse_args(argv)
    run_generation(tp=args.tp, device=args.device)
    run_generation(temperature=0.9, top_k=8, top_p=0.95, seed=3,
                   device=args.device)
    run_speculative(device=args.device)
    run_beam(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
