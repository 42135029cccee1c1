"""The port's HRNet backbone against ``torchok_tpu``, f32 on the CPU.

* Every registered name's input and four branch shapes at 64x64 against
  ``tests/data/backbone_shapes.json``, transposed to NCHW.
* ``hrnet_w18_small`` at 32x32, eval and train mode, from the same weights:
  each branch within 1e-4 of its largest magnitude, the running statistics
  after the train forward within 1e-5. The weights are the port's own init
  with random norms, carried into the Flax tree by
  ``torchok_tpu.utils.torch_convert.convert_state_dict``: that reverse bridge
  leaves no Flax leaf missing and no port key unused.
* ``flax_to_state_dict`` carries the JAX HRNet's names onto the port's.

``test_torch_hrnet_classification.py`` holds a ``_w_cfg`` name and the
classification neck.
"""
import copy
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.models.backbones import hrnet as jax_hrnet
from torchok_tpu.utils.torch_convert import convert_state_dict
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.backbones import hrnet as port_hrnet
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict

REPO = Path(__file__).resolve().parent.parent
NAMES = sorted(port_hrnet.CFGS)
# one module a stage, one block a branch, widths 8 to 64
CUT = jax_hrnet._hrnet_cfg(16, 1, 8, (1, 2, "BASIC", [1, 1], [8, 16]),
                           (1, 3, "BASIC", [1, 1, 1], [8, 16, 32]),
                           (1, 4, "BASIC", [1, 1, 1, 1], [8, 16, 32, 64]))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def assert_maps_close(got, want, tol=1e-4, what=""):
    """NCHW ``got`` against NHWC ``want``, within ``tol`` of its largest magnitude."""
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def random_norms(model, generator):
    """Norm scales, shifts and running statistics drawn at random, so no
    block is the identity its zero-initialised last norm makes it."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.weight.uniform_(0.4, 0.9, generator=generator)
                m.bias.normal_(0.0, 0.1, generator=generator)
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)


def draw_variables(shapes, rng):
    """Flax variables of these shapes at random: kernels at unit fan-in
    variance, biases and means N(0, 0.1), norm scales and variances
    uniform in [0.4, 0.9]."""

    def draw(path, s):
        leaf = str(path[-1].key)
        if leaf == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.4, 0.9, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def random_variables(module, rng, *args):
    """Random Flax variables of ``module`` (shapes by tracing its init, no
    compiled init)."""
    return draw_variables(jax.eval_shape(lambda r: module.init(r, *args), jax.random.PRNGKey(0)),
                          rng)


def port_weights(name, model, flax_module, x, seed=0):
    """The port model's init with random norms, and the same weights as
    Flax variables through the reverse bridge (no leaf missing, no key
    unused)."""
    generator = torch.Generator()
    generator.manual_seed(seed)
    model.init_weights(generator)
    random_norms(model, generator)
    shapes = jax.eval_shape(lambda r: flax_module.init(r, jnp.asarray(x), False),
                            jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    variables, report = convert_state_dict(name, state, template)
    assert not report.missing and not report.unused, report.summary()
    assert report.converted == len(state)
    return variables


def flax_variables(state):
    """A port HRNet ``state_dict`` as the JAX HRNet's Flax variables, by
    inverting the names ``flax_to_state_dict`` gives (no traced template)."""
    variables = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *mod, leaf = key.split(".")
        path, i = [], 0
        while i < len(mod):
            part = mod[i]
            if part == "layer1" or re.fullmatch(r"stage\d", part):
                path.append(f"{part}_{mod[i + 1]}")
                i += 2
            elif part == "branches":
                path.append(f"branch_{mod[i + 1]}_block_{mod[i + 2]}")
                i += 3
            elif part == "downsample":
                path += ["downsample", "conv" if mod[i + 1] == "0" else "bn"]
                i += 2
            elif part == "fuse_layers" or re.fullmatch(r"transition\d", part):
                kind = "conv" if mod[-1] == "0" else "bn"
                if part == "fuse_layers":
                    path += ["fuse", "_".join(["fuse", *mod[i + 1:-1], kind])]
                else:
                    path += [part, f"t_{mod[i + 1]}_{kind}"]
                i = len(mod)
            else:
                path.append(part)
                i += 1
        value = value.numpy()
        collection, name = {"weight": ("params", "kernel" if value.ndim == 4 else "scale"),
                            "bias": ("params", "bias"), "running_mean": ("batch_stats", "mean"),
                            "running_var": ("batch_stats", "var")}[leaf]
        node = variables[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value.transpose(2, 3, 1, 0) if name == "kernel" else value
    return variables


@pytest.mark.parametrize("name", NAMES)
def test_branch_shapes_match_the_jax_shape_table(name):
    entry = json.loads((REPO / "tests" / "data" / "backbone_shapes.json").read_text())[
        "entries"][name]
    hw = entry["hw"]
    with torch.inference_mode():
        model = BACKBONES.get(name)().eval()
        feats = model.forward_features(torch.zeros(1, 3, hw, hw))
    want = [[n, c, h, w] for n, h, w, c in entry["shapes"]]
    assert [list(f.shape) for f in feats] == want
    assert list(model.out_encoder_channels) == model.out_channels == [s[1] for s in want[1:]]


@pytest.fixture(scope="module")
def w18_small():
    """hrnet_w18_small in both packages with the same weights, and 8 images."""
    name = "hrnet_w18_small"
    x = np.random.default_rng(1).normal(size=(8, 32, 32, 3)).astype(np.float32)
    flax_model = JAX_BACKBONES.get(name)()
    model = BACKBONES.get(name)()
    variables = port_weights(name, model, flax_model, x)
    return flax_model, variables, model, x


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_hrnet_w18_small_matches_torchok_tpu_at_32(w18_small, mode):
    flax_model, variables, model, x = w18_small
    model = copy.deepcopy(model)
    train = mode == "train"
    want, new = jax.jit(lambda v, x: flax_model.apply(v, x, train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model.train(train)
    with torch.no_grad():
        got = model(nchw(x))
    assert len(got) == 4
    for b, (g, w) in enumerate(zip(got, want)):
        assert_maps_close(g, w, what=f"branch {b}")
    if train:  # 8 values a channel at the 1x1 branch
        after = flax_to_state_dict("hrnet_w18_small",
                                   {"params": {}, "batch_stats": new["batch_stats"]})
        state = model.state_dict()
        assert len(after) == 2 * sum(1 for k in state if k.endswith("running_var"))
        for key, value in after.items():
            np.testing.assert_allclose(state[key].numpy(), value, rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_flax_names_carry_onto_the_timm_names(monkeypatch):
    """The forward bridge: every leaf of a JAX HRNet's variables lands on a
    port key of the same shape (a new branch's transition nested, the fuse
    layers' chains numbered as timm numbers them)."""
    monkeypatch.setitem(jax_hrnet.CFGS, "hrnet_w18_small", CUT)
    monkeypatch.setitem(port_hrnet.CFGS, "hrnet_w18_small", CUT)
    x = np.zeros((1, 32, 32, 3), np.float32)
    flax_model = JAX_BACKBONES.get("hrnet_w18_small")()
    shapes = jax.eval_shape(lambda r: flax_model.init(r, jnp.asarray(x), False),
                            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), shapes)
    state = flax_to_state_dict("hrnet_w18_small", variables)
    model = BACKBONES.get("hrnet_w18_small")()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: v.shape for k, v in state.items()} == want
    assert "transition3.3.0.0.weight" in state and "transition1.0.0.weight" in state
    assert "stage4.0.fuse_layers.3.0.2.0.weight" in state
    assert "stage4.0.fuse_layers.0.3.1.running_var" in state


