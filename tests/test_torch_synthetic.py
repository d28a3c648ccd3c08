"""The port's synthetic LM data (``repro_torch.data.synthetic``) against the
reference's ``repro.data.synthetic``: the Zipf token stream and the numpy
batches bit for bit, and ``input_specs`` (meta tensors) against the
reference's ``ShapeDtypeStruct`` trees, shape and dtype, for every arch at
its published and reduced widths and every shape cell."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.data import synthetic as jsyn
from repro_torch import configs
from repro_torch.data import synthetic as syn
from repro_torch.nn import named_leaves

torch.set_num_threads(1)


def test_token_stream_equals_reference_and_resumes():
    port = syn.SyntheticTokens(vocab_size=1000, batch=3, seq=17, seed=5)
    ref = jsyn.SyntheticTokens(vocab_size=1000, batch=3, seq=17, seed=5)
    for _ in range(5):
        got, want = next(port), next(ref)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    assert port.state_dict() == ref.state_dict() == {"seed": 5, "step": 5}
    resumed = syn.SyntheticTokens(vocab_size=1000, batch=3, seq=17)
    resumed.load_state_dict(ref.state_dict())
    ahead = next(ref)
    for k, v in next(resumed).items():
        np.testing.assert_array_equal(v, ahead[k])
    assert iter(port) is port


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_make_batch_equals_reference(arch, kind):
    cfg = configs.get_reduced_config(arch)
    jcfg = jconfigs.get_reduced_config(arch)
    got = syn.make_batch(np.random.default_rng(3), cfg, 2, 9, kind)
    want = jsyn.make_batch(np.random.default_rng(3), jcfg, 2, 9, kind)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    got = syn.make_decode_batch(np.random.default_rng(4), cfg, 3)
    want = jsyn.make_decode_batch(np.random.default_rng(4), jcfg, 3)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _specs(tree: dict) -> dict:
    """{"/"-path: (shape, dtype name)} of the port's meta tensors."""
    return {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in named_leaves(tree).items()}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    for scale in ("full", "reduced"):
        get = "get_config" if scale == "full" else "get_reduced_config"
        cfg = getattr(configs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        for shape, jshape in zip(configs.ALL_SHAPES, jconfigs.ALL_SHAPES):
            got = syn.input_specs(cfg, shape)
            assert all(t.device.type == "meta"
                       for t in named_leaves(got).values())
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    _flatten_with_paths(jsyn.input_specs(jcfg, jshape))[0]}
            assert _specs(got) == want, (scale, shape.name)
