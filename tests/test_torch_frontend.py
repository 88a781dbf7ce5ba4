"""The port's serving frontend (``serving/frontend.py``), its policy
(``serving/policy.py``) and the engine's sampled decode, on the CPU.

Tiny GPT with flax weights bridged into the port, fp32. Mirrors the
reference's ``tests/test_frontend.py`` and its sampled-engine cases:

- the policy orders and picks victims as the reference's on random
  entries;
- ``run()``'s greedy tokens and ``decode_steps`` equal JAX's engine, and
  its stats keys are the reference's plus ``generated_tokens``;
- sampled tokens are scheduling-invariant (``num_slots``, ``sync_every``,
  a forced preemption) and equal lock-step ``generate``'s rows;
- streaming order, cancellation freeing pages, the background pump,
  forced preemption keeping greedy tokens, deadlock, pump death failing
  every handle, and shutdown under load.

Every test that starts a pump thread stops it (``stop`` joins with a
timeout) and bounds every wait, so none can hang the suite.
"""

import queue as queue_mod
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.serving import PagedDecodeEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving.policy import PriorityDeadlinePolicy as JaxPolicy
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import GPTModel, generate, gpt_tiny_config
from apex_tpu_torch.serving import (PagedDecodeEngine,
                                    PriorityDeadlinePolicy, Request,
                                    ServingError, ServingFrontend,
                                    free_page_count)

PS = 8
WAIT_S = 120.0


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _prompt(rng, n):
    return rng.integers(0, 128, (n,)).astype(np.int32)


def _ref(tm, req, **kw):
    p = np.asarray(req.prompt)
    return generate(tm, torch.from_numpy(p)[None], req.max_new_tokens,
                    **kw)[0, p.shape[0]:].numpy()


def _no_leak(engine):
    usable = engine.cache["free_stack"].shape[0] - 1
    cached = len(engine.prefix) if engine.prefix is not None else 0
    assert free_page_count(engine.cache) == usable - cached
    assert int(engine.cache["page_ref"].sum()) == 0


# --- policy --------------------------------------------------------------------


class _E:
    def __init__(self, priority=0, deadline_at=None, arrival=0.0, seq=0):
        self.priority = priority
        self.deadline_at = deadline_at
        self.arrival = arrival
        self.seq = seq


def test_policy_orders_and_picks_victims_as_the_reference():
    rng = np.random.default_rng(0)
    for trial in range(30):
        entries = [_E(int(rng.integers(0, 3)),
                      None if rng.random() < 0.4 else float(rng.random()),
                      float(rng.integers(0, 3)), i) for i in range(8)]
        now = float(rng.random())
        kw = dict(preemption=bool(trial % 5), preempt_margin_ms=float(
            rng.integers(0, 500)), preempt_on_priority=bool(trial % 2))
        ours, theirs = PriorityDeadlinePolicy(**kw), JaxPolicy(**kw)
        assert (sorted(entries, key=lambda e: ours.sort_key(e, now))
                == sorted(entries, key=lambda e: theirs.sort_key(e, now)))
        active = {s: e for s, e in enumerate(entries[:4])}
        for cand in entries[4:]:
            assert (ours.select_victim(cand, active, now)
                    == theirs.select_victim(cand, active, now))
            assert ours.wants_preempt(cand, now) == \
                theirs.wants_preempt(cand, now)
            assert ours.at_risk(cand, now) == theirs.at_risk(cand, now)


def test_request_defaults_are_plain_fifo_traffic():
    r = Request(np.zeros((4,), np.int32), 3)
    assert (r.priority, r.deadline_ms, r.arrival_time, r.tpot_slo_ms,
            r.trace_id) == (0, None, None, None, None)


# --- run() through the frontend ------------------------------------------------


def test_run_matches_jax_engine_and_its_stats_keys(pair):
    """Greedy ``run()`` through the frontend: tokens and ``decode_steps``
    equal JAX's engine at ``sync_every`` 2 with an EOS; the stats keys are
    the reference's plus ``generated_tokens`` (the keys of state the port
    does not have hold its values: no compiles, one card, no host
    tier)."""
    jm, variables, tm = pair
    rng = np.random.default_rng(1)
    work = [(_prompt(rng, int(s)), int(m))
            for s, m in zip((5, 17, 9, 30, 12), (7, 3, 12, 5, 9))]
    eos = int(_ref(tm, Request(*work[2]))[3])
    kw = dict(num_slots=2, page_size=PS, sync_every=2, eos_token_id=eos)
    eng = PagedDecodeEngine(tm, **kw)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    j_outs, j_stats = JaxEngine(jm, variables, **kw).run(
        [JaxRequest(prompt=p, max_new_tokens=n) for p, n in work])
    for a, b in zip(outs, j_outs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert stats["decode_steps"] == j_stats["decode_steps"]
    assert set(stats) == set(j_stats) | {"generated_tokens"}
    assert (stats["jit.compiles"], stats["compile_storms"],
            stats["tp_world"], stats["host_tier_enabled"]) == (0, 0, 1,
                                                              False)
    assert stats["generated_tokens"] == sum(len(o) for o in outs)
    assert len(eng.ttft_ms) == len(work) and all(
        t is not None and t >= 0 for t in eng.ttft_ms)
    _no_leak(eng)


# --- sampled decode ----------------------------------------------------------------


SAMPLE_KW = dict(temperature=1.0, top_k=20, top_p=0.9, rng=7)


@pytest.mark.parametrize("num_slots,sync_every", [(1, 1), (3, 1), (2, 3),
                                                  (5, 2)])
def test_sampled_engine_is_scheduling_invariant(pair, num_slots, sync_every):
    """Sampled tokens depend on the request and the seed alone: every
    (num_slots, sync_every) gives lock-step ``generate``'s rows (request
    ``i`` draws stream ``i``, as row ``i`` does)."""
    _, _, tm = pair
    rng = np.random.default_rng(2)
    prompts = np.stack([_prompt(rng, 9) for _ in range(5)])
    want = generate(tm, torch.from_numpy(prompts), 8,
                    **SAMPLE_KW)[:, 9:].numpy()
    eng = PagedDecodeEngine(tm, num_slots=num_slots, page_size=PS,
                            sync_every=sync_every, **SAMPLE_KW)
    outs, _ = eng.run([Request(p, 8) for p in prompts])
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)
    _no_leak(eng)


def _forced_preemption(tm, low, hi, *, warm_pumps=3, **engine_kw):
    engine = PagedDecodeEngine(tm, num_slots=len(low), page_size=PS,
                               **engine_kw)
    fe = ServingFrontend(
        engine, policy=PriorityDeadlinePolicy(preempt_on_priority=True))
    handles = [fe.submit(r, request_id=i) for i, r in enumerate(low)]
    while fe.queue_depth:
        fe.pump()
    for _ in range(warm_pumps):
        fe.pump()
    handles.append(fe.submit(hi, request_id=len(low)))
    fe.drain()
    return fe, handles


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("sampled", [False, True])
def test_forced_preemption_keeps_tokens(pair, sampled, prefix_cache):
    """A high-priority arrival that must evict a low-priority slot leaves
    every request's tokens as an undisturbed run's, greedy and sampled
    (the resume continues its stream at its token index), with the prefix
    cache (the spill path: the resume hits its whole written prefix) and
    without (recompute); preemptions > 0, resumes == preemptions, no page
    leaks."""
    _, _, tm = pair
    rng = np.random.default_rng(3)
    low = [Request(_prompt(rng, 24), 16) for _ in range(2)]
    hi = Request(_prompt(rng, 24), 8, priority=5)
    kw = SAMPLE_KW if sampled else {}
    plain, _ = PagedDecodeEngine(tm, num_slots=3, page_size=PS, **kw).run(
        low + [hi])
    fe, handles = _forced_preemption(tm, low, hi,
                                     prefix_cache=prefix_cache, **kw)
    stats = fe.stats()
    assert stats["preemptions"] >= 1
    assert stats["resumes"] == stats["preemptions"]
    for h, ref in zip(handles, plain):
        np.testing.assert_array_equal(h.result(timeout=0), ref)
    if prefix_cache:
        ring = fe.engine.events.tail()
        preempts = {e["request"]: e for e in ring if e["kind"] == "preempt"}
        for ev in (e for e in ring if e["kind"] == "resume"):
            generated = preempts[ev["request"]]["generated"]
            assert ev["cached_pages"] == (24 + generated - 1) // PS
        assert stats["prefill_tokens_skipped"] >= PS
    life = fe.tracer.lifecycle(next(iter(preempts)) if prefix_cache else
                               next(e["request"]
                                    for e in fe.engine.events.tail()
                                    if e["kind"] == "preempt"))
    assert life["preemptions"] >= 1 and life["preempted_ms"] >= 0
    _no_leak(fe.engine)


def test_preemption_on_off_identical_via_run(pair):
    _, _, tm = pair
    rng = np.random.default_rng(4)
    reqs = [Request(_prompt(rng, s), m, priority=p)
            for s, m, p in zip((16, 24, 9), (10, 6, 12), (0, 3, 1))]
    outs = [PagedDecodeEngine(tm, num_slots=2, page_size=PS,
                              prefix_cache=True).run(reqs, policy=pol)[0]
            for pol in (PriorityDeadlinePolicy(preemption=False),
                        PriorityDeadlinePolicy(preempt_on_priority=True))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# --- streaming -------------------------------------------------------------------


def test_streaming_tokens_in_order_and_eos_termination(pair):
    _, _, tm = pair
    prompt = _prompt(np.random.default_rng(5), 8)
    ref = _ref(tm, Request(prompt, 6))
    eos = int(ref[2])
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                                           eos_token_id=eos))
    h = fe.submit(Request(prompt, 6))
    streamed = []
    while fe.pump():
        try:
            while (tok := h.get(timeout=0)) is not None:
                streamed.append(tok)
        except queue_mod.Empty:
            pass
    streamed.extend(list(h))
    out = h.result(timeout=0)
    assert h.done and streamed == list(out) == h.tokens_so_far()
    first = int(np.where(ref == eos)[0][0])
    assert int(out[-1]) == eos and list(out) == list(ref[:first + 1])
    assert list(h) == []


def test_streaming_cancel_stops_stream_and_frees_pages(pair):
    _, _, tm = pair
    prompt = _prompt(np.random.default_rng(6), 9)
    engine = PagedDecodeEngine(tm, num_slots=1, page_size=PS)
    fe = ServingFrontend(engine)
    h = fe.submit(Request(prompt, 30))
    for _ in range(4):
        fe.pump()
    h.cancel()
    fe.drain()
    out = h.result(timeout=0)
    assert 1 <= out.shape[0] < 30
    np.testing.assert_array_equal(out, _ref(tm, Request(prompt, 30))[
        :out.shape[0]])
    _no_leak(engine)
    fe2 = ServingFrontend(engine)
    h2 = fe2.submit(Request(prompt, 4))
    h2.cancel()
    fe2.drain()
    assert h2.result(timeout=0).shape[0] == 0


def test_background_pump_thread(pair):
    _, _, tm = pair
    prompt = _prompt(np.random.default_rng(7), 10)
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=2, page_size=PS))
    fe.start()
    try:
        out = fe.submit(Request(prompt, 5)).result(timeout=WAIT_S)
    finally:
        fe.stop(timeout=WAIT_S)
    assert not fe.pump_alive
    np.testing.assert_array_equal(out, _ref(tm, Request(prompt, 5)))


# --- failure and shutdown -------------------------------------------------------


def test_deadlock_still_raises_and_fails_handles(pair):
    _, _, tm = pair
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                                           num_pages=3, max_pages_per_seq=8))
    with pytest.raises(ValueError, match="more pages than the pool"):
        fe.submit(Request(np.zeros((30,), np.int32), 10))


class _KillAt:
    """A fault hook: the pump dies at its ``at``-th iteration."""

    def __init__(self, at):
        self.at, self.n = at, 0

    def on_pump(self, frontend):
        self.n += 1
        if self.n >= self.at:
            raise RuntimeError("injected pump death")

    def on_submit(self, frontend, request):
        pass


def test_pump_death_fails_every_handle(pair):
    """A pump that dies mid-decode fails every live handle (result and
    iteration raise ``ServingError``), on the background thread and on
    the synchronous path, and later submits raise."""
    _, _, tm = pair
    rng = np.random.default_rng(8)
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=2, page_size=PS),
                         fault_hook=_KillAt(3))
    fe.start()
    try:
        h = fe.submit(Request(_prompt(rng, 10), 40))
        with pytest.raises(ServingError):
            h.result(timeout=WAIT_S)
        with pytest.raises(ServingError):
            for _ in h:
                pass
        assert fe.failure is not None
        with pytest.raises(ServingError, match="pump has failed"):
            fe.submit(Request(_prompt(rng, 10), 4))
    finally:
        fe.stop(timeout=WAIT_S)
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=2, page_size=PS),
                         fault_hook=_KillAt(3))
    handles = [fe.submit(Request(_prompt(rng, 8), 30)) for _ in range(4)]
    with pytest.raises(RuntimeError, match="injected"):
        fe.drain()
    for h in handles:
        assert h.done
        with pytest.raises(ServingError):
            h.result(timeout=0)


@pytest.mark.parametrize("mode", ["drain", "cancel"])
def test_shutdown_under_load_resolves_deterministically(pair, mode):
    _, _, tm = pair
    rng = np.random.default_rng(9)
    engine = PagedDecodeEngine(tm, num_slots=2, page_size=PS,
                               prefix_cache=True)
    fe = ServingFrontend(engine)
    handles = [fe.submit(Request(_prompt(rng, 10), 16), request_id=i)
               for i in range(6)]
    fe.start()
    try:
        handles[0].get(timeout=WAIT_S)
        fe.shutdown(deadline_s=WAIT_S, mode=mode)
    finally:
        fe.stop(timeout=WAIT_S)
    for h in handles:
        assert h.done
        out = h.result(timeout=0)
        assert out.shape[0] == 16 if mode == "drain" else out.shape[0] <= 16
    with pytest.raises(ServingError, match="shutting down"):
        fe.submit(Request(np.zeros((4,), np.int32), 2))
    assert not fe.pump_alive
    assert "serving-frontend-pump" not in {
        t.name for t in threading.enumerate()}
    _no_leak(engine)


def test_deadline_miss_and_tpot_slo_counted(pair):
    """An already-expired TTFT deadline is counted once, and a TPOT
    objective no run can meet is counted at retirement with the burn
    gauge at 1."""
    _, _, tm = pair
    rng = np.random.default_rng(10)
    fe = ServingFrontend(PagedDecodeEngine(tm, num_slots=1, page_size=PS))
    fe.submit(Request(_prompt(rng, 8), 4, deadline_ms=-1.0))
    fe.submit(Request(_prompt(rng, 8), 4, tpot_slo_ms=1e-9))
    fe.drain()
    stats = fe.stats()
    assert stats["deadline_misses"] == 1
    assert stats["tpot_slo_misses"] == 1
    assert stats["slo_burn"] == 1.0
    assert stats["ttft_ms_p50"] > 0 and stats["tpot_ms_p50"] > 0


def test_backpressure_spills_a_stalled_consumer_and_resumes(pair):
    """A consumer that reads nothing past ``backpressure_window`` tokens
    has its slot spilled through the preemption path and held out until it
    reads; reading the stream then finishes with the undisturbed run's
    tokens and no page leaked."""
    _, _, tm = pair
    prompt = _prompt(np.random.default_rng(11), 12)
    want = _ref(tm, Request(prompt, 12))
    engine = PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                               prefix_cache=True)
    fe = ServingFrontend(engine, backpressure_window=2)
    h = fe.submit(Request(prompt, 12))
    for _ in range(6):                   # nobody reads: the slot spills
        fe.pump()
    assert fe.counter_deltas()["backpressure_spills"] >= 1
    assert fe.queue_depth == 1 and not fe.pump()  # held until it reads
    streamed = []
    while not h.done:
        try:
            while (tok := h.get(timeout=0)) is not None:
                streamed.append(tok)
        except queue_mod.Empty:
            pass
        fe.pump()
    streamed.extend(list(h))
    np.testing.assert_array_equal(np.asarray(streamed), want)
    np.testing.assert_array_equal(h.result(timeout=0), want)
    _no_leak(engine)
