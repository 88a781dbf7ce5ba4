"""Rank workers of the tensor-parallel and data-parallel tests
(``tests/test_torch_tp_*.py``, ``tests/test_torch_parallel_ranks.py``):
each runs in one spawned process of a ``gloo`` group
(``apex_tpu_torch.parallel.spawn.run_ranks``) and returns numpy arrays.
Imports no JAX, so that the ranks start quickly; the JAX side of every
comparison runs in the test process on the same inputs, which
:func:`layer_inputs` draws from a numpy seed for both."""

import numpy as np
import torch

#: the seven regions' case names (the sequence gather twice: with the
#: reduce-scatter backward and with the split)
REGIONS = ("copy", "reduce", "scatter", "gather", "sp_scatter",
           "sp_gather", "sp_gather_split", "sp_reduce_scatter")
#: the layer cases
LAYERS = ("column_gather", "column_local", "row_scatter", "row_parallel",
          "mlp", "sequence_parallel", "embedding", "attend")


def layer_inputs(tp: int, seed: int = 0) -> dict:
    """Every case's inputs at ``tp`` ranks: full tensors, per-rank
    tensors stacked on a leading ``tp`` axis, cotangents, weights."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    s = 2 * tp                                  # rows split over the ranks
    return dict(
        x_full=f(s, 3, 4 * tp), x_rank=f(tp, s, 3, 4 * tp),
        g_full=f(tp, s, 3, 4 * tp), g_block=f(tp, s, 3, 4),
        g_rows=f(tp, 2, 3, 4 * tp),
        lin_x=f(6, 16), col_w=f(32, 16) * 0.25, col_b=f(32),
        col_g=f(6, 32), row_w=f(8, 16) * 0.25, row_b=f(8), row_g=f(6, 8),
        mlp_w1=f(16, 8) * 0.3, mlp_w2=f(8, 16) * 0.3, mlp_x=f(4, 8),
        mlp_g=f(4, 8), sp_x=f(8, 8), sp_w1=f(16, 8) * 0.3,
        sp_w2=f(8, 16) * 0.3, sp_g=f(8, 8),
        ids=rng.integers(0, 32, (5, 7)).astype(np.int32),
        emb_w=f(32, 8) * 0.5, emb_g=f(5, 7, 8), att_x=f(5, 8),
        att_g=f(5, 32), ce_logits=f(6, 32) * 3,
        ce_target=rng.integers(0, 32, (6,)).astype(np.int32))


def _block(a, dim, tp, r):
    return np.split(a, tp, axis=dim)[r]


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _vjp(out, cot, *wrt):
    grads = torch.autograd.grad(out, wrt, _t(cot), allow_unused=True)
    return [out.detach().numpy()] + [None if g is None else g.numpy()
                                     for g in grads]


def region_cases(rank: int, tp: int, inp: dict) -> dict:
    """Output and input gradient of each region on this rank's inputs."""
    from apex_tpu_torch.transformer.tensor_parallel import mappings as m

    full, mine = inp["x_full"], inp["x_rank"][rank]
    g_full, g_block = inp["g_full"][rank], inp["g_block"][rank]
    g_rows = inp["g_rows"][rank]
    plans = {
        "copy": (full, m.copy_to_tensor_model_parallel_region, g_full),
        "reduce": (mine, m.reduce_from_tensor_model_parallel_region, g_full),
        "scatter": (full, m.scatter_to_tensor_model_parallel_region,
                    g_block),
        "gather": (_block(mine, -1, tp, rank),
                   m.gather_from_tensor_model_parallel_region, g_full),
        "sp_scatter": (full, m.scatter_to_sequence_parallel_region, g_rows),
        "sp_gather": (_block(mine, 0, tp, rank),
                      m.gather_from_sequence_parallel_region, g_full),
        "sp_gather_split": (
            _block(mine, 0, tp, rank),
            lambda x: m.gather_from_sequence_parallel_region(
                x, tensor_parallel_output_grad=False), g_full),
        "sp_reduce_scatter": (
            mine, m.reduce_scatter_to_sequence_parallel_region, g_rows)}
    out = {}
    for name in REGIONS:
        x, fn, cot = plans[name]
        x = _t(x, True)
        out[name] = _vjp(fn(x), cot, x)
    return out


def _load(layer, **tensors):
    with torch.no_grad():
        for name, value in tensors.items():
            getattr(layer, name).copy_(torch.from_numpy(value))


def layer_cases(rank: int, tp: int, inp: dict) -> dict:
    """Output and gradients (input, then the rank's weight shards) of each
    layer case."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

    out = {}
    for name, gather in (("column_gather", True), ("column_local", False)):
        lin = ColumnParallelLinear(16, 32, gather_output=gather,
                                   world_size=tp, device="cpu")
        _load(lin, weight=_block(inp["col_w"], 0, tp, rank),
              bias=_block(inp["col_b"], 0, tp, rank))
        x = _t(inp["lin_x"], True)
        cot = (inp["col_g"] if gather
               else _block(inp["col_g"], 1, tp, rank))
        out[name] = _vjp(lin(x), cot, x, lin.weight, lin.bias)
    for name, par in (("row_scatter", False), ("row_parallel", True)):
        lin = RowParallelLinear(16, 8, input_is_parallel=par, world_size=tp,
                                device="cpu")
        _load(lin, weight=_block(inp["row_w"], 1, tp, rank),
              bias=inp["row_b"])
        x = _t(_block(inp["lin_x"], 1, tp, rank) if par else inp["lin_x"],
               True)
        out[name] = _vjp(lin(x), inp["row_g"], x, lin.weight, lin.bias)
    for name, sp in (("mlp", False), ("sequence_parallel", True)):
        w1, w2 = ((inp["sp_w1"], inp["sp_w2"]) if sp
                  else (inp["mlp_w1"], inp["mlp_w2"]))
        cpl = ColumnParallelLinear(8, 16, gather_output=False, bias=False,
                                   world_size=tp,
                                   sequence_parallel_enabled=sp,
                                   device="cpu")
        rpl = RowParallelLinear(16, 8, input_is_parallel=True, bias=False,
                                world_size=tp, sequence_parallel_enabled=sp,
                                device="cpu")
        _load(cpl, weight=_block(w1, 0, tp, rank))
        _load(rpl, weight=_block(w2, 1, tp, rank))
        if sp:
            x = _t(_block(inp["sp_x"], 0, tp, rank), True)
            y = rpl(cpl(x))
            cot = _block(inp["sp_g"], 0, tp, rank)
        else:
            x = _t(inp["mlp_x"], True)
            y = rpl(torch.nn.functional.gelu(cpl(x), approximate="tanh"))
            cot = inp["mlp_g"]
        out[name] = _vjp(y, cot, x, cpl.weight, rpl.weight)
    emb = VocabParallelEmbedding(32, 8, world_size=tp, device="cpu")
    _load(emb, weight=_block(inp["emb_w"], 0, tp, rank))
    out["embedding"] = _vjp(emb(torch.from_numpy(inp["ids"])), inp["emb_g"],
                            emb.weight)
    x = _t(inp["att_x"], True)
    out["attend"] = _vjp(emb.attend(x), _block(inp["att_g"], 1, tp, rank),
                         x, emb.weight)
    return out


def cross_entropy_cases(rank: int, tp: int, inp: dict) -> dict:
    """Per-token losses and the logits' gradient (of their sum) at
    smoothing 0 and 0.1."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy)

    out = {}
    for smoothing in (0.0, 0.1):
        lg = _t(_block(inp["ce_logits"], 1, tp, rank), True)
        loss = vocab_parallel_cross_entropy(
            lg, torch.from_numpy(inp["ce_target"]), smoothing)
        out[smoothing] = _vjp(loss, np.ones(6, np.float32), lg)
    return out


def misc_cases(rank: int, tp: int) -> dict:
    """The RNG tracker, ``broadcast_data``, ``checkpoint`` and the
    collectives on this rank."""
    from apex_tpu_torch import collectives as coll
    from apex_tpu_torch.transformer.tensor_parallel import (
        broadcast_data, checkpoint, get_rng_state_tracker,
        model_parallel_seed)

    model_parallel_seed(123, device="cpu")
    tracker = get_rng_state_tracker()
    states = tracker.get_states()
    with tracker.fork():
        mp_draw = torch.rand(4, generator=tracker.generator()).numpy()
    with tracker.fork("default"):
        default_draw = torch.rand(4, generator=tracker.generator()).numpy()
    tracker.set_states(states)
    with tracker.fork():
        replay = torch.rand(4, generator=tracker.generator()).numpy()
    bcast = broadcast_data(["x", "n"], {
        "x": torch.full((2, 3), float(rank)),
        "n": torch.arange(3, dtype=torch.int64) + rank})

    def block(x):
        # dropout drawn from the model-parallel stream
        with tracker.fork():
            keep = torch.rand(x.shape, generator=tracker.generator()) > 0.3
        return (torch.tanh(x) * keep).sum()

    x = torch.linspace(-2, 2, 8, requires_grad=True)
    tracker.set_states(states)
    g_plain = torch.autograd.grad(block(x), x)[0].numpy()
    tracker.set_states(states)
    g_ckpt = torch.autograd.grad(checkpoint(block, False, x), x)[0].numpy()
    v = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    colls = dict(
        sum=coll.all_reduce(v).numpy(), max=coll.all_reduce(v, op="max")
        .numpy(), mean=coll.all_reduce(v, op="mean").numpy(),
        gather0=coll.all_gather(v, dim=0).numpy(),
        gather1=coll.all_gather(v, dim=1).numpy(),
        scatter=coll.reduce_scatter(torch.arange(4.0 * tp).reshape(
            2 * tp, 2) * (rank + 1), dim=0).numpy(),
        bcast=coll.broadcast(v, src=tp - 1).numpy())
    return dict(mp_draw=mp_draw, default_draw=default_draw, replay=replay,
                bcast_x=bcast["x"].numpy(), bcast_n=bcast["n"].numpy(),
                g_plain=g_plain, g_ckpt=g_ckpt, colls=colls,
                backend=coll.backend())


def layers_worker(rank: int, world: int) -> dict:
    """Every case of ``tests/test_torch_tp_layers.py`` on this rank."""
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.initialize_model_parallel(world)
    try:
        inp = layer_inputs(world)
        return dict(regions=region_cases(rank, world, inp),
                    layers=layer_cases(rank, world, inp),
                    ce=cross_entropy_cases(rank, world, inp),
                    misc=misc_cases(rank, world))
    finally:
        parallel_state.destroy_model_parallel()


def _tiny_gpt(world: int, sd_full: dict, **cfg_kw):
    """This rank's tiny GPT (fp32, CPU) holding its shard of ``sd_full``
    (a tp = 1 state dict of numpy arrays)."""
    from apex_tpu_torch.bridge import shard_gpt_params
    from apex_tpu_torch.models import GPTModel, gpt_tiny_config
    from apex_tpu_torch.transformer import parallel_state

    model = GPTModel(gpt_tiny_config(tensor_parallel_size=world, **cfg_kw),
                     device="cpu")
    full = {k: torch.from_numpy(v) for k, v in sd_full.items()}
    model.load_state_dict(shard_gpt_params(
        full, world, parallel_state.get_tensor_model_parallel_rank()))
    return model


def gpt_train_worker(rank: int, world: int, sd_full: dict, ids, labels,
                     cfg_kw: dict) -> dict:
    """Loss and every gradient of this rank's shard of tiny GPT, and the
    greedy tokens of that shard and of a tp = 1 model evaluated in the same
    rank (its loss too), which must keep its full-vocab logits."""
    from apex_tpu_torch.models import gpt_loss
    from apex_tpu_torch.models.generation import generate
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.initialize_model_parallel(world)
    try:
        model = _tiny_gpt(world, sd_full, **cfg_kw)
        tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
        loss = gpt_loss(model, tids, tlabels)
        loss.backward()
        tp1 = _tiny_gpt(1, sd_full, **cfg_kw)
        with torch.no_grad():
            tp1_loss = float(gpt_loss(tp1, tids, tlabels))
        prompt = tids[:, :8]
        return dict(loss=float(loss.detach()),
                    grads={n: p.grad.numpy() for n, p in
                           model.named_parameters()},
                    tokens=generate(model, prompt, 4).numpy(),
                    tp1_loss=tp1_loss,
                    tp1_tokens=generate(tp1, prompt, 4).numpy())
    finally:
        parallel_state.destroy_model_parallel()


def _serving_validation(model, sd_full: dict, kw: dict) -> dict:
    """``shard_model_variables`` against ``bridge.shard_gpt_params``, and
    the named errors of a tp = 1 model in a TP engine and of a checkpoint
    of local shapes."""
    from apex_tpu_torch.bridge import shard_gpt_params
    from apex_tpu_torch.models import GPTModel, gpt_tiny_config
    from apex_tpu_torch.serving import (TensorParallelPagedEngine,
                                        shard_model_variables)
    from apex_tpu_torch.transformer import parallel_state

    full = {k: torch.from_numpy(v) for k, v in sd_full.items()}
    mine = shard_model_variables(model, full)
    want = shard_gpt_params(full, model.config.tensor_parallel_size,
                            parallel_state.get_tensor_model_parallel_rank())
    errors = {}
    for name, call in (
            ("tp1_model", lambda: TensorParallelPagedEngine(
                GPTModel(gpt_tiny_config(), device="cpu"), **kw)),
            ("local_shapes", lambda: shard_model_variables(
                model, model.state_dict()))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    return dict(same_as_bridge=all(torch.equal(mine[k], want[k])
                                   for k in want), errors=errors)


def gpt_serving_worker(rank: int, world: int, sd_full: dict, requests,
                       eos: int) -> dict:
    """This rank's tensor-parallel engines over ``requests``: greedy, the
    s > 1 programs (self-draft speculative decode, chunked prefill),
    sampled at two schedules, a cold and a warm prefix-cached run, and a
    frontend with a priority preemption."""
    from apex_tpu_torch.serving import TensorParallelPagedEngine, Request
    from apex_tpu_torch.serving.frontend import ServingFrontend
    from apex_tpu_torch.serving.policy import PriorityDeadlinePolicy
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.initialize_model_parallel(world)
    try:
        model = _tiny_gpt(world, sd_full)
        kw = dict(num_slots=2, page_size=8, eos_token_id=eos)
        out = dict(validation=_serving_validation(model, sd_full, kw))

        def run(reqs=requests, **extra):
            eng = TensorParallelPagedEngine(model, **dict(kw, **extra))
            outs, stats = eng.run(reqs)
            return [np.asarray(o) for o in outs], stats, eng

        greedy, stats, eng = run()
        out.update(greedy=greedy, stats=stats,
                   pool_kv_heads=eng.cache["layers"][0]["k_pages"].shape[1])
        spec, sstats, _ = run(draft_model=model, draft_len=2)
        out.update(spec=spec, spec_acceptance=sstats["spec_tokens"]
                   / max(sstats["spec_rounds"], 1))
        chunked, cstats, _ = run(prefill_chunk=8)
        out.update(chunked=chunked,
                   chunked_prefills=cstats["chunked_prefills"])
        samp = dict(temperature=0.9, top_k=16, rng=7)
        out["sampled_a"] = run(requests[:3], sync_every=1, **samp)[0]
        out["sampled_b"] = run(requests[:3], sync_every=3,
                               **dict(samp, num_slots=3))[0]
        rng = np.random.default_rng(11)
        hdr = rng.integers(2, 128, 16).astype(np.int32)
        preqs = [Request(prompt=np.concatenate(
            [hdr, rng.integers(2, 128, 4).astype(np.int32)]),
            max_new_tokens=5) for _ in range(4)]
        peng = TensorParallelPagedEngine(model, prefix_cache=True, **kw)
        peng.run(preqs)
        warm, wstats = peng.run(preqs)
        cache = peng.cache
        out.update(prefix_requests=preqs, prefix_warm=warm,
                   prefix_hits=wstats["prefix_hits"],
                   prefix_skipped=wstats["prefill_tokens_skipped"],
                   prefix_pool_ok=(int(cache["page_ref"].sum()) == 0
                                   and cache["free_top"]
                                   == cache["free_stack"].shape[0] - 1
                                   - len(peng.prefix)))
        feng = TensorParallelPagedEngine(model, prefix_cache=True, **kw)
        fe = ServingFrontend(feng, policy=PriorityDeadlinePolicy(
            preempt_on_priority=True))
        ereqs = [Request(prompt=rng.integers(2, 128, 12).astype(np.int32),
                         max_new_tokens=12, priority=0) for _ in range(2)]
        ereqs.append(Request(prompt=rng.integers(2, 128, 6).astype(
            np.int32), max_new_tokens=3, priority=9))
        low = [fe.submit(r) for r in ereqs[:2]]
        for _ in range(3):
            fe.pump()
        hi = fe.submit(ereqs[2])
        fe.drain()
        fstats = fe.stats()
        out.update(preempt_stats=fstats, preempt_requests=ereqs,
                   preempt_outputs=[np.asarray(h.result(timeout=0))
                                    for h in low + [hi]])
        return out
    finally:
        parallel_state.destroy_model_parallel()


def bn_inputs(seed: int = 0) -> dict:
    """SyncBatchNorm's NCHW batch of 16 (mean 1, std 3), its weight and
    bias, and the DDP gradients of each of two ranks."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(x=(rng.standard_normal((16, 8, 3, 3)) * 3 + 1).astype(f32),
                w=(1 + 0.1 * rng.standard_normal(8)).astype(f32),
                b=(0.1 * rng.standard_normal(8)).astype(f32),
                grads=[rng.standard_normal((4, 3)).astype(f32)
                       for _ in range(2)])


def parallel_worker(rank: int, world: int, steps: int) -> dict:
    """SyncBatchNorm forward and backward on this rank's half of the batch,
    DDP's gradient average (dict and in-place, every knob), its parameter
    broadcast, the DDP example, ResNet (tiny) through ``main_amp`` and the
    found-inf agreement under tensor parallelism; first the cuDNN and
    cuBLAS flags the rank started with."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.examples.simple import distributed_data_parallel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         SyncBatchNorm)
    from apex_tpu_torch.parallel.spawn import backend_flags
    from apex_tpu_torch.transformer import parallel_state

    flags = backend_flags()
    inp = bn_inputs()
    per = 16 // world
    bn = SyncBatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    x = _t(inp["x"][rank * per:(rank + 1) * per], True)
    y = bn(x)
    (y * y).sum().backward()
    out = dict(flags=flags, bn_y=y.detach().numpy(), bn_dx=x.grad.numpy(),
               bn_dw=bn.weight.grad.numpy(), bn_db=bn.bias.grad.numpy(),
               bn_mean=bn.running_mean.numpy(), bn_var=bn.running_var.numpy())

    net = torch.nn.Linear(3, 4)
    with torch.no_grad():
        net.weight.fill_(float(rank))         # rank 0's values must win
    g = {"w": torch.from_numpy(inp["grads"][rank])}
    knobs = [dict(), dict(gradient_average=False),
             dict(gradient_predivide_factor=2.0),
             dict(allreduce_always_fp32=True)]
    out["ddp"] = [DistributedDataParallel(net, **k).allreduce_gradients(g)
                  ["w"].numpy() for k in knobs]
    out["ddp_weight"] = net.weight.detach().numpy()
    ddp = DistributedDataParallel(net, allreduce_always_fp32=True)
    net.weight.grad = torch.full((4, 3), float(rank + 1),
                                 dtype=torch.float32)
    net.bias.grad = torch.full((4,), float(rank + 1))
    ddp.allreduce_gradients()
    out["ddp_inplace"] = (net.weight.grad.numpy(), net.bias.grad.numpy())

    out["example_losses"] = distributed_data_parallel.run_training(
        steps, device="cpu", verbose=lambda *_: None)
    torch.manual_seed(0)
    out["resnet_losses"] = main_amp.run_training(
        main_amp.resnet_tiny(device="cpu"), steps=3, batch_size=8,
        image_size=16, opt_level="O0", device="cpu",
        verbose=lambda *_: None)
    amp.reset()

    parallel_state.initialize_model_parallel(world)
    try:
        p = torch.nn.Parameter(torch.ones(4))
        opt = FusedAdam([("p", p)], lr=0.1)
        opt.attach_amp_scaler(LossScaler("dynamic", init_scale=2.0 ** 8))
        skips = []
        for step in range(2):
            before = p.detach().clone()
            p.grad = torch.full((4,), 1.0)
            if step == 0 and rank == world - 1:
                p.grad[2] = float("inf")      # one rank overflows
            opt.step()
            skips.append(dict(
                unchanged=bool(torch.equal(p.detach(), before)),
                scale=float(opt._amp_scaler.state.scale),
                step_count=int(opt.step_count)))
        out["found_inf"] = skips
    finally:
        parallel_state.destroy_model_parallel()
    return out
