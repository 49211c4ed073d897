"""Captured programs (`repro_torch.launch.capture`) and the serving
engine's compile-once promise, without jax: a program's data flow and
counts on the CPU, the cached step programs and ``generate`` against an
eager loop, and on the card, at a smoke-variant Hymba (two layers, narrow
widths, flash and SSD both on the path, bf16): replay equal to the eager
body bit for bit for decode and prefill, no build across a hot swap and
node-mask flips, the body eager only in its warm-up, ``LAUNCHES`` equal to
the warm-up plus one capture delta per replay, and no synchronizing op in
a warm-up, a replay or an eager body.

Card-only cases skip without a CUDA device (decided inside the test). On
the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_capture.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch.capture import (WARMUP, Program,  # noqa: E402
                                        ProgramPool)
from repro_torch.launch.serve import (generate,  # noqa: E402
                                      prefill_step_for, serve_step_for,
                                      step_buffers, tree_leaves)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import BucketPolicy, ServeEngine  # noqa: E402

torch.set_num_threads(2)

N = 3
SEQ = (16, 32)
MAX_LEN = 40


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(arch="hymba-1.5b", dev=torch.device("cpu")):
    cfg = smoke_variant(get_config(arch))
    if dev.type == "cuda":
        cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    return build_model(cfg)


def _ensemble(model, dev, n=N, seed=0):
    dtype = getattr(torch, model.cfg.param_dtype)
    ens = torch.empty((n, model.layout.size), dtype=dtype, device=dev)
    for i in range(n):
        model.init(torch.Generator(device=dev).manual_seed(seed + i), dev,
                   out=ens[i])
    return ens


def _engine(dev, model=None, max_slots=2):
    model = model or _model(dev=dev)
    return ServeEngine(model, _ensemble(model, dev), max_len=MAX_LEN,
                       max_slots=max_slots, device=dev,
                       policy=BucketPolicy(batch_buckets=(1, 2),
                                           seq_buckets=SEQ))


def _serve(eng, rng, lengths, max_new=4):
    reqs = [eng.submit(rng.integers(0, 64, n), max_new) for n in lengths]
    eng.drain()
    assert all(r.status == "done" for r in reqs)
    return reqs


def _eager_generate(model, params, prompt, max_new, max_len):
    """The greedy loop run eagerly, fresh caches, Python-int positions."""
    views = model.layout.unflatten(params)
    b, s = prompt.shape
    caches = model.init_cache(b, max_len, params.device)
    logits, _ = model.prefill(views, {"tokens": prompt}, caches)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(max_new - 1):
        logits, _ = model.decode(views, tok, caches, s + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# the CPU: a program is its body
# ---------------------------------------------------------------------------

def test_program_on_cpu_runs_its_body():
    x = torch.zeros(3)
    reset_launches()
    prog = ProgramPool("cpu").capture(lambda: x.add_(1.0))
    assert isinstance(prog, Program) and not prog.captured
    assert prog.eager_calls == 0
    for _ in range(3):
        prog.run()
    assert x.tolist() == [3.0, 3.0, 3.0]
    assert (prog.eager_calls, prog.replays, prog.launches) == (3, 0, {})
    assert all(v == 0 for v in LAUNCHES.values())


def test_step_programs_are_cached_per_key():
    model = _model()
    cpu = torch.device("cpu")
    dec = serve_step_for(model, 2, MAX_LEN, cpu)
    assert serve_step_for(model, 2, MAX_LEN, cpu) is dec
    assert serve_step_for(model, 1, MAX_LEN, cpu) is not dec
    pre = prefill_step_for(model, 2, 16, MAX_LEN, cpu)
    assert prefill_step_for(model, 2, 16, MAX_LEN, cpu) is pre
    assert prefill_step_for(model, 2, 32, MAX_LEN, cpu) is not pre
    st = step_buffers(model, 2, MAX_LEN, cpu)
    assert set(st.prompts) == {16, 32}
    assert st.tok.dtype == st.pos.dtype == torch.long


@pytest.mark.parametrize("arch", ["hymba-1.5b", "minicpm-2b"])
def test_generate_equals_the_eager_loop(arch):
    """``generate`` (prefill program, then the decode program replayed with
    its position on the device) equals the eager greedy loop, and a second
    call on the same step buffers gives the same tokens."""
    model = _model(arch)
    params = _ensemble(model, torch.device("cpu"), n=1)[0]
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (2, 16)))
    want = _eager_generate(model, params, prompt, 6, MAX_LEN)
    got = generate(model, params, prompt, 6, MAX_LEN, device="cpu")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(generate(model, params, prompt, 6, MAX_LEN,
                                device="cpu"), want)
    with pytest.raises(ValueError, match="max_len"):
        generate(model, params, prompt, MAX_LEN, MAX_LEN, device="cpu")


def test_engine_builds_once_per_key_on_cpu():
    """Each key is built once, on every pool buffer; a second wave, a hot
    swap and node-mask flips build nothing; on the CPU every dispatch
    runs the body."""
    eng = _engine(torch.device("cpu"))
    rng = np.random.default_rng(1)
    _serve(eng, rng, (16, 32, 16))
    warm = dict(eng.trace_counts)
    assert all(v == 1 for v in warm.values())
    assert set(eng.programs) == {(k, i) for k in warm for i in (0, 1)}
    eng.swap(_ensemble(eng.model, eng.device, seed=9))
    eng.fail_node(1)
    _serve(eng, rng, (16, 32, 16))
    eng.restore_node(1)
    _serve(eng, rng, (16, 32, 16))
    assert dict(eng.trace_counts) == warm
    assert all(not p.captured and p.replays == 0
               for p in eng.programs.values())
    # three waves on buffer 0 or 1: each wave's dispatches ran the bodies
    assert sum(p.eager_calls for p in eng.programs.values()) > 3 * len(warm)


# ---------------------------------------------------------------------------
# the card: captured graphs
# ---------------------------------------------------------------------------

def _snapshot(eng):
    return [t.clone() for t in tree_leaves(eng._table)] + [eng._out.clone()]


def _restore(eng, snap):
    for t, s in zip(tree_leaves(eng._table) + [eng._out], snap):
        t.copy_(s)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_replay_equals_eager_body_on_card(kind):
    dev = _cuda()
    eng = _engine(dev)
    _serve(eng, np.random.default_rng(2), (16, 32, 16))
    keys = [k for k in eng.trace_counts if k[0] == kind]
    assert keys
    for key in keys:
        prog = eng.programs[key, 0]
        before = _snapshot(eng)
        prog.run()
        replayed = _snapshot(eng)
        _restore(eng, before)
        prog.body()
        eager = _snapshot(eng)
        torch.cuda.synchronize()
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b), key


def test_no_builds_across_swap_and_mask_flips_on_card():
    dev = _cuda()
    eng = _engine(dev)
    rng = np.random.default_rng(3)
    _serve(eng, rng, (16,))                # the keys of the flow below
    _serve(eng, rng, (16, 32, 16))
    warm = dict(eng.trace_counts)
    eng.submit(rng.integers(0, 64, 16), 6)
    eng.step()
    v1 = eng.swap(_ensemble(eng.model, dev, seed=7))
    late = eng.submit(rng.integers(0, 64, 32), 4)
    eng.fail_node(0)
    eng.step()
    eng.restore_node(0)
    eng.drain()
    assert late.param_version == v1 and late.status == "done"
    assert dict(eng.trace_counts) == warm
    assert len(eng.slot.pool) == 2


def test_body_runs_eagerly_only_in_warmup_on_card():
    dev = _cuda()
    eng = _engine(dev)
    rng = np.random.default_rng(4)
    for _ in range(2):
        _serve(eng, rng, (16, 32))
    assert eng.programs
    for prog in eng.programs.values():
        assert prog.captured and prog.eager_calls == WARMUP
    assert sum(p.replays for p in eng.programs.values()) > 0


def test_launches_count_replays_on_card():
    dev = _cuda()
    eng = _engine(dev)
    reset_launches()
    _serve(eng, np.random.default_rng(5), (32,), max_new=1)
    prog = eng.programs[("prefill", 32, 1), 0]
    per_pass = eng.model.cfg.n_layers * N
    assert prog.launches == {"flash_attention": per_pass,
                             "ssd_scan": per_pass}
    # a build's warm-up passes (one program per pool buffer) and one replay
    builds = WARMUP * len(eng.slot.pool)
    assert LAUNCHES["flash_attention"] == (builds + 1) * per_pass
    k = 3
    reset_launches()
    for _ in range(k):
        prog.run()
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == LAUNCHES["ssd_scan"] == k * per_pass
    assert prog.replays == 1 + k


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m"])
def test_programs_do_not_sync_on_card(arch):
    """No synchronizing op in a replay or an eager body, the moe model's
    routing, dispatch and combine included."""
    dev = _cuda()
    eng = _engine(dev, _model(arch, dev))
    rng = np.random.default_rng(6)
    _serve(eng, rng, (16, 32))
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(1, device=dev).item()     # the check has teeth
        for (key, _), prog in eng.programs.items():
            if key[0] == "prefill":              # a slot in the bucket
                eng._stage_prefill(rng.integers(0, 64, key[1]), 0, key[1])
            prog.run()
            prog.body()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


def test_profiler_sees_replayed_kernels_on_card():
    """A profiled replay shows one flash and one SSD ``chunk_out`` record
    per launch the program counts."""
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    eng = _engine(dev)
    _serve(eng, np.random.default_rng(7), (32,), max_new=1)
    prog = eng.programs[("prefill", 32, 1), 0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.run()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = sum(e.count for e in cuda if "flash_kernel" in e.key)
    ssd = sum(e.count for e in cuda if "chunk_out_kernel" in e.key)
    assert (flash, ssd) == (prog.launches["flash_attention"],
                            prog.launches["ssd_scan"])
