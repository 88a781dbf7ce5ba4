"""Tensor-parallel serving on the card: two ranks, each a process (both on
``cuda:0`` over ``gloo`` on a one-card machine, a card each over ``nccl``
where there are two), against tp = 1 in this process.

Marked ``cuda``: skips (inside the ``cuda`` fixture) where there is no
CUDA device. Imports no JAX (the GPU machine runs the ``cuda`` tests with
``--noconftest``): ``python -m pytest --noconftest tests/test_torch_cuda_tp.py
-q``. GPT-2-small at full width, 2 layers, fp32: greedy tokens identical
to tp = 1 request by request, the same decode steps, each rank's pool
half of tp = 1's, every serving kernel launched on both ranks, and the
ranks on the backend that ``parallel.spawn.choose_backend`` gives this
machine.
"""

import pytest
import torch

from apex_tpu_torch.examples.tensor_parallel import gpt as tpg
from apex_tpu_torch.ops import _build
from apex_tpu_torch.parallel import run_ranks
from apex_tpu_torch.parallel.spawn import choose_backend

pytestmark = pytest.mark.cuda

SERVING_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    _build.build_all()              # the ranks load what this process built
    return torch.device("cuda")


def test_tp2_greedy_tokens_equal_tp1_on_the_card(cuda):
    kw = dict(config="gpt2_small",
              cfg_kw=dict(dtype=torch.float32, num_layers=2), seed=0,
              requests=tpg.demo_requests(50304, 4, seed=1),
              engine_kw=dict(num_slots=4, page_size=16), device="cuda")
    ref = tpg.serve_rank(0, 1, **kw)
    ranks = [jobs[0] for jobs in run_ranks(
        tpg.jobs_rank, 2, ([("serve", kw)],), device="cuda", timeout=300)]
    for r in ranks:
        assert r["backend"] == choose_backend(2, "cuda")
        assert r["stats"]["decode_steps"] == ref["stats"]["decode_steps"]
        assert 2 * r["pool_bytes"] == ref["pool_bytes"]
        for got, want in zip(r["outputs"], ref["outputs"]):
            assert got.tolist() == want.tolist()
        assert all(r["launches"][k] > 0 for k in SERVING_KERNELS)
