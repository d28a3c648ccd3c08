"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither jax nor the reference, so it runs on a GPU
machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance 2e-5: f32 sums in another order, scaled by C=10 through tanh.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import instances as tinst
from repro_torch.core.policy import (CoRaiSPolicy, PolicyConfig,
                                     corais_encode, corais_score_decode)
from repro_torch.kernels import ops, policy_score, ref
from repro_torch.serving.fastpath import DecisionFastPath

pytestmark = pytest.mark.cuda

ATOL = 2e-5
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, b=3, q=6, q_valid=3, z=37, d=32, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(d)
    c = rng.normal(size=(b, q, d)).astype(np.float32)
    h = rng.normal(size=(b, z, d)).astype(np.float32)
    wx = rng.uniform(-bound, bound, size=(d, d)).astype(np.float32)
    wy = rng.uniform(-bound, bound, size=(d, d)).astype(np.float32)
    mask = np.zeros((b, q), bool)
    mask[:, :q_valid] = True
    return [torch.from_numpy(a).to(device) for a in (c, h, wx, wy, mask)]


@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_kernels_match_plain_versions(cuda_device, normalize):
    c, h, wx, wy, mask = _inputs(cuda_device)
    policy_score.reset_launch_counts()
    lp = ops.policy_score(c, h, wx, wy, mask)
    torch.testing.assert_close(lp, ref.policy_score_torch(c, h, wx, wy, mask),
                               atol=ATOL, rtol=0)
    ti, tv = ops.policy_score_decode(c, h, wx, wy, mask, k=3,
                                     normalize=normalize)
    wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0, 3,
                                           normalize)
    torch.testing.assert_close(ti, wi)
    torch.testing.assert_close(tv, wv, atol=ATOL, rtol=0)
    assert policy_score.LAUNCHES == {"policy_score": 1,
                                     "policy_score_decode": 1}


def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    c, h, wx, wy, mask = _inputs(cuda_device)
    maskf = mask.to(torch.float32)
    with pytest.raises(TypeError, match="float32"):
        policy_score.policy_score_cuda(c.double(), h, wx, wy, maskf)
    with pytest.raises(ValueError, match="contiguous"):
        policy_score.policy_score_cuda(c, h, wx.T, wy, maskf)
    with pytest.raises(ValueError, match="k=7"):
        policy_score.policy_score_decode_cuda(c, h, wx, wy, maskf, k=7)


def test_cuda_fast_path_matches_cpu_fast_path(cuda_device):
    """Same weights, same instances: the fast path on the card (kernels)
    returns the CPU fast path's (plain versions) greedy decisions."""
    cfg = PolicyConfig(**SMALL)
    cpu = CoRaiSPolicy(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    gpu = CoRaiSPolicy(cfg, generator=torch.Generator().manual_seed(0),
                       device=cuda_device)
    buckets = ((8, 32),)
    fp_cpu = DecisionFastPath(cpu, buckets=buckets, device="cpu")
    fp_gpu = DecisionFastPath(gpu, buckets=buckets, device=cuda_device)
    rng = np.random.default_rng(1)
    policy_score.reset_launch_counts()
    for _ in range(3):
        inst = tinst.generate_instance(rng, tinst.InstanceConfig(
            num_edges=6, num_requests=20))
        got, want = fp_gpu.decide(inst), fp_cpu.decide(inst)
        with torch.inference_mode():  # rows whose top-2 scores are apart
            t = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
            c, h = corais_encode(cpu, t)
            _, tv = corais_score_decode(cpu, c, h, t["edge_mask"], k=2,
                                        normalize=False, backend="torch")
        gapped = (tv[:, 0] - tv[:, 1] > 1e-4).numpy()
        assert gapped.mean() > 0.9
        np.testing.assert_array_equal(got[gapped], want[gapped])
    assert policy_score.LAUNCHES["policy_score_decode"] == 3
