"""Serving demo on the PyTorch/CUDA port (the twin of
``examples/serve_demo.py``): batched greedy generation against a KV cache,
plus the serving plane — a continuous-batching consensus ensemble with
hot-swappable params (docs/serving.md).

Shows all three decode-state families: KV cache (dense, moe), recurrent SSM
state (mamba2), and enc-dec cross-attention (seamless). On the card each
decode step and prefill is a captured CUDA graph, built at its first call
(the warm-up below) and replayed after it.

Run:  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.serve import generate, serve_step_for, step_buffers
from repro_torch.models import build_model, nest
from repro_torch.models.encdec import encode
from repro_torch.serve import BucketPolicy, ServeEngine

ARCHS = ("minicpm-2b",             # dense, KV cache
         "mamba2-370m",            # ssm, O(1) state
         "phi3.5-moe-42b-a6.6b",   # moe decode with expert routing
         "seamless-m4t-medium")    # enc-dec cross-attention
BATCH, PROMPT_LEN, MAX_LEN, MAX_NEW = 4, 8, 64, 16


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo(arch: str, params=None, device="cuda", max_new: int = MAX_NEW):
    """Greedy generation of ``max_new`` tokens for a batch of 4 on
    ``arch``'s smoke variant, from ``params`` (one node's flat ``[P]``;
    drawn from seed 0 when not given). Returns the ``tokens`` [4, max_new]
    (on the CPU), the ``prompt`` (or the enc-dec model's ``frames``) it
    fed, and the timed run's ``seconds``."""
    device = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    params = params.to(device)
    b = BATCH
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (b, PROMPT_LEN))
    frames = np.random.default_rng(2).normal(
        0, 1, (b, cfg.enc_seq_len, cfg.frontend_dim)).astype(np.float32)

    def run():
        if cfg.is_encdec:
            st = step_buffers(model, b, MAX_LEN, device)
            step = serve_step_for(model, b, MAX_LEN, device)
            st.params.copy_(params)
            for t in st.caches["self"]:
                t["k"].zero_()
                t["v"].zero_()
            st.caches["enc_out"].copy_(encode(
                nest(st.views), cfg, torch.from_numpy(frames).to(device)))
            st.tok.zero_()
            st.pos.zero_()
            outs = []
            for _ in range(max_new):
                step.run()
                outs.append(st.tok.clone())
            return torch.cat(outs, dim=1).to(torch.int32)
        return generate(model, params, prompt, max_new, MAX_LEN,
                        device=device)

    run()              # warm-up: builds the captured programs on the card
    _sync(device)
    t0 = time.perf_counter()
    out = run().cpu()
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{arch:24s} [{cfg.family:6s}] generated {tuple(out.shape)} "
          f"({dt / max_new * 1000:.1f} ms/token) "
          f"sample: {out[0, :8].tolist()}")
    return dict(tokens=out, seconds=dt,
                **({"frames": frames} if cfg.is_encdec
                   else {"prompt": prompt}))


def demo_ensemble(params=None, device="cuda", arch: str = "minicpm-2b",
                  n_nodes: int = 4):
    """Continuous-batching consensus over N stacked per-node variants — the
    ``SwarmState.params`` layout served directly as one ensemble. From
    ``params`` ``[N, P]`` (node i drawn from seed i when not given).
    Returns the 6 timed requests, their ``seconds`` and the engine's
    ``total_traces`` (builds of captured programs)."""
    device = resolve_device(device)
    cfg = smoke_variant(get_config(arch)).replace(vocab_size=256)
    model = build_model(cfg)
    if params is None:
        params = torch.stack([model.init(torch.Generator(
            device=device).manual_seed(i), device) for i in range(n_nodes)])
    eng = ServeEngine(model, params, mode="consensus", max_len=48,
                      max_slots=4,
                      policy=BucketPolicy(batch_buckets=(1, 2, 4),
                                          seq_buckets=(16,)),
                      device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n), dtype=np.int32)
               for n in rng.integers(4, 12, size=6)]
    for p in prompts[:4]:                      # warm the bucket grid
        eng.submit(p, max_new=2)
    eng.drain()
    _sync(device)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    eng.drain()
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{arch:24s} [swarm ] {n_nodes}-node consensus served "
          f"{len(reqs)} reqs in {dt * 1000:.0f} ms "
          f"({len(reqs) / dt:.1f} req/s, {eng.total_traces} builds) "
          f"sample: {reqs[0].tokens}")
    return dict(requests=reqs, seconds=dt, total_traces=eng.total_traces)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {arch: demo(arch, device=device) for arch in ARCHS}
    out["ensemble"] = demo_ensemble(device=device)
    print("OK — batched greedy serving across 4 decode-state families "
          "+ continuous-batching swarm consensus.")
    return out


if __name__ == "__main__":
    main()
