"""HRNet for classification in the port against ``torchok_tpu``, f32 on the
CPU: the path of ``hrnet_w18`` with ``HRNetClassificationNeck`` (the
benchmark's ``hrnet_w18_224_bs128``).

* ``hrnet_w18`` (a ``_w_cfg`` name) at 64x64 in eval mode from the same
  weights (the port's init with random norms, named for Flax by
  ``tests.test_torch_hrnet.flax_variables``: a traced template would take
  longer than the forward), each branch within 1e-4 of its largest
  magnitude.
* ``HRNetClassificationNeck`` against the JAX module with its random Flax
  variables carried by ``flax_to_state_dict``, in eval and train mode,
  within 1e-4 of the output's largest magnitude. As in the JAX package, each
  incre output is summed into the stride-2 cascade.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.models.necks.classification.hrnet import \
    HRNetClassificationNeck as FlaxClassificationNeck
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.necks.classification.hrnet import HRNetClassificationNeck
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict
from tests.test_torch_hrnet import (assert_maps_close, flax_variables, nchw, random_norms,
                                    random_variables)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_w_cfg_name_matches_torchok_tpu_at_64():
    name = "hrnet_w18"
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    model = BACKBONES.get(name)().eval()
    generator = torch.Generator()
    generator.manual_seed(1)
    model.init_weights(generator)
    random_norms(model, generator)
    want = JAX_BACKBONES.get(name)().apply(flax_variables(model.state_dict()), jnp.asarray(x),
                                            False)
    with torch.no_grad():
        got = model(nchw(x))
    for b, (g, w) in enumerate(zip(got, want)):
        assert_maps_close(g, w, what=f"branch {b}")


def _neck_inputs(rng, widths, size):
    return [rng.normal(size=(4, size >> i, size >> i, w)).astype(np.float32)
            for i, w in enumerate(widths)]


def test_classification_neck_matches_torchok_tpu():
    widths = (16, 32, 64, 128)
    xs = _neck_inputs(np.random.default_rng(3), widths, 8)
    flax_neck = FlaxClassificationNeck(in_channels=widths)
    variables = random_variables(flax_neck, np.random.default_rng(4),
                                 [jnp.asarray(x) for x in xs], False)
    neck = HRNetClassificationNeck(in_channels=widths)
    state = flax_to_state_dict("HRNetClassificationNeck", variables)
    neck.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    assert "incre_0.downsample.0.weight" in state and "final.conv.weight" in state
    for train in (False, True):
        want, _ = jax.jit(lambda v, xs: flax_neck.apply(v, xs, train, mutable=["batch_stats"]))(
            variables, [jnp.asarray(x) for x in xs])
        neck.train(train)
        with torch.no_grad():
            got = neck([nchw(x) for x in xs])
        assert neck.out_channels == got.shape[1] == 2048
        assert_maps_close(got, want, what=f"train={train}")
