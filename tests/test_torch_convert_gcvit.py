"""GCViT full-network torch-oracle forward equivalence for the weight
converter. The state dict uses timm-0.6 gcvit checkpoint naming (the
reference composes timm.models.gcvit Stem/GlobalContextVitStage directly,
reference torchok/models/backbones/gcvit.py:18,92-118): stem.conv1 +
stem.down.{norm1,conv_block,reduction,norm2}, stages.{i}.downsample on the
FOLLOWING stage, global_block.blocks.conv{j}, per-block
attn.{qkv,rel_pos.relative_position_bias_table,proj} / ls{1,2}.gamma, and a
stage-internal norm on the last stage. The forward is an independent
torch.nn.functional re-implementation."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from torchok_tpu.models.backbones.gcvit import GlobalContextVit, _rel_pos_index
from torchok_tpu.models.modules.blocks.se import make_divisible
from torchok_tpu.utils.torch_convert import convert_state_dict

IMG = 32
DIM = 8
DEPTHS = (2, 2)
HEADS = (2, 2)
WS = 4
LS = 0.1
MLP_RATIO = 2.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the oracle: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(gen, *shape):
    return torch.from_numpy(gen.normal(0, 0.1, shape).astype(np.float32))


def _mb_sd(sd, gen, p, c):
    rd = make_divisible(c * 0.25, 8, round_limit=0.0)
    sd[f"{p}.conv_dw.weight"] = _rand(gen, c, 1, 3, 3)
    sd[f"{p}.se.fc1.weight"] = _rand(gen, rd, c, 1, 1)
    sd[f"{p}.se.fc2.weight"] = _rand(gen, c, rd, 1, 1)
    sd[f"{p}.conv_pw.weight"] = _rand(gen, c, c, 1, 1)


def _down_sd(sd, gen, p, c_in, c_out):
    sd[f"{p}.norm1.weight"] = _rand(gen, c_in) + 1.0
    sd[f"{p}.norm1.bias"] = _rand(gen, c_in)
    _mb_sd(sd, gen, f"{p}.conv_block", c_in)
    sd[f"{p}.reduction.weight"] = _rand(gen, c_out, c_in, 3, 3)
    sd[f"{p}.norm2.weight"] = _rand(gen, c_out) + 1.0
    sd[f"{p}.norm2.bias"] = _rand(gen, c_out)


def _gcvit_sd(gen):
    sd = {"stem.conv1.weight": _rand(gen, DIM, 3, 3, 3),
          "stem.conv1.bias": _rand(gen, DIM)}
    _down_sd(sd, gen, "stem.down", DIM, DIM)
    num_rel = (2 * WS - 1) ** 2
    for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        c = DIM * 2 ** i
        p = f"stages.{i}"
        if i > 0:
            _down_sd(sd, gen, f"{p}.downsample", c // 2, c)
        # feature map: 8x8 at stage 0 (1 level), 4x4 at stage 1 (0 levels)
        levels = max(1, int(math.log2((IMG // 4 // 2 ** i) // WS))
                     if (IMG // 4 // 2 ** i) >= WS else 0)
        for j in range(levels):
            _mb_sd(sd, gen, f"{p}.global_block.blocks.conv{j + 1}", c)
        hidden = int(c * MLP_RATIO)
        for b in range(depth):
            bp = f"{p}.blocks.{b}"
            nkv = 2 if b % 2 == 1 else 3
            sd[f"{bp}.norm1.weight"] = _rand(gen, c) + 1.0
            sd[f"{bp}.norm1.bias"] = _rand(gen, c)
            sd[f"{bp}.attn.qkv.weight"] = _rand(gen, nkv * c, c)
            sd[f"{bp}.attn.qkv.bias"] = _rand(gen, nkv * c)
            sd[f"{bp}.attn.rel_pos.relative_position_bias_table"] = \
                _rand(gen, num_rel, heads)
            sd[f"{bp}.attn.proj.weight"] = _rand(gen, c, c)
            sd[f"{bp}.attn.proj.bias"] = _rand(gen, c)
            sd[f"{bp}.ls1.gamma"] = _rand(gen, c)
            sd[f"{bp}.norm2.weight"] = _rand(gen, c) + 1.0
            sd[f"{bp}.norm2.bias"] = _rand(gen, c)
            sd[f"{bp}.mlp.fc1.weight"] = _rand(gen, hidden, c)
            sd[f"{bp}.mlp.fc1.bias"] = _rand(gen, hidden)
            sd[f"{bp}.mlp.fc2.weight"] = _rand(gen, c, hidden)
            sd[f"{bp}.mlp.fc2.bias"] = _rand(gen, c)
            sd[f"{bp}.ls2.gamma"] = _rand(gen, c)
    sd[f"stages.{len(DEPTHS) - 1}.norm.weight"] = _rand(gen, DIM * 2) + 1.0
    sd[f"stages.{len(DEPTHS) - 1}.norm.bias"] = _rand(gen, DIM * 2)
    return sd


def _mb(sd, p, x):
    c = x.shape[1]
    y = F.conv2d(x, sd[f"{p}.conv_dw.weight"], None, padding=1, groups=c)
    y = F.gelu(y)
    s = y.mean((2, 3), keepdim=True)
    s = F.gelu(F.conv2d(s, sd[f"{p}.se.fc1.weight"], None))
    s = F.conv2d(s, sd[f"{p}.se.fc2.weight"], None)
    y = y * torch.sigmoid(s)
    y = F.conv2d(y, sd[f"{p}.conv_pw.weight"], None)
    return x + y


def _ln2d(x, sd, p):
    y = x.permute(0, 2, 3, 1)
    y = F.layer_norm(y, (y.shape[-1],), sd[f"{p}.weight"], sd[f"{p}.bias"],
                     eps=1e-5)
    return y.permute(0, 3, 1, 2)


def _down(sd, p, x):
    x = _ln2d(x, sd, f"{p}.norm1")
    x = _mb(sd, f"{p}.conv_block", x)
    x = F.conv2d(x, sd[f"{p}.reduction.weight"], None, stride=2, padding=1)
    return _ln2d(x, sd, f"{p}.norm2")


def _partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(wins, ws, h, w):
    c = wins.shape[-1]
    b = wins.shape[0] // (h * w // ws // ws)
    x = wins.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _attn(sd, p, win, qg, heads, ws, use_global):
    b_, l, c = win.shape
    d = c // heads
    if use_global:
        kv = F.linear(win, sd[f"{p}.qkv.weight"], sd[f"{p}.qkv.bias"])
        kv = kv.reshape(b_, l, 2, heads, d).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        q = qg.repeat_interleave(b_ // qg.shape[0], dim=0)
        q = q.reshape(b_, l, heads, d).permute(0, 2, 1, 3)
    else:
        qkv = F.linear(win, sd[f"{p}.qkv.weight"], sd[f"{p}.qkv.bias"])
        qkv = qkv.reshape(b_, l, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    idx = torch.from_numpy(_rel_pos_index(ws).reshape(-1)).long()
    table = sd[f"{p}.rel_pos.relative_position_bias_table"]
    bias = table[idx].reshape(l, l, heads).permute(2, 0, 1)
    attn = (attn + bias.unsqueeze(0)).softmax(-1)
    out = (attn @ v).transpose(1, 2).reshape(b_, l, c)
    return F.linear(out, sd[f"{p}.proj.weight"], sd[f"{p}.proj.bias"])


def _gcvit_torch_forward(sd, x):
    x = F.conv2d(x, sd["stem.conv1.weight"], sd["stem.conv1.bias"],
                 stride=2, padding=1)
    x = _down(sd, "stem.down", x)
    for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        p = f"stages.{i}"
        if i > 0:
            x = _down(sd, f"{p}.downsample", x)
        n, c, h, w = x.shape
        levels = int(math.log2(min(h, w) // WS)) if min(h, w) >= WS else 0
        qg, red = x, levels
        for j in range(max(1, levels)):
            qg = _mb(sd, f"{p}.global_block.blocks.conv{j + 1}", qg)
            if red > 0:
                qg = F.max_pool2d(qg, 3, 2, 1)
                red -= 1
        qg = qg.permute(0, 2, 3, 1)[:, :WS, :WS].reshape(n, WS * WS, c)
        t = x.permute(0, 2, 3, 1)
        for b in range(depth):
            bp = f"{p}.blocks.{b}"
            y = F.layer_norm(t, (c,), sd[f"{bp}.norm1.weight"],
                             sd[f"{bp}.norm1.bias"], 1e-5)
            a = _attn(sd, f"{bp}.attn", _partition(y, WS), qg, heads, WS,
                      use_global=b % 2 == 1)
            t = t + _reverse(a, WS, h, w) * sd[f"{bp}.ls1.gamma"]
            y = F.layer_norm(t, (c,), sd[f"{bp}.norm2.weight"],
                             sd[f"{bp}.norm2.bias"], 1e-5)
            y = F.gelu(F.linear(y, sd[f"{bp}.mlp.fc1.weight"],
                                sd[f"{bp}.mlp.fc1.bias"]))
            y = F.linear(y, sd[f"{bp}.mlp.fc2.weight"],
                         sd[f"{bp}.mlp.fc2.bias"])
            t = t + y * sd[f"{bp}.ls2.gamma"]
        if i == len(DEPTHS) - 1:
            t = F.layer_norm(t, (c,), sd[f"{p}.norm.weight"],
                             sd[f"{p}.norm.bias"], 1e-5)
        x = t.permute(0, 3, 1, 2)
    return t  # NHWC, last stage (normed)


def test_gcvit_forward_matches_torch_oracle():
    gen = np.random.default_rng(23)
    sd = _gcvit_sd(gen)
    # img_size is part of the build config (timm gcvit.py:82-86): it sizes
    # the FeatureBlock reduction depth; the oracle sd is built for IMG
    model = GlobalContextVit(embed_dim=DIM, depths=DEPTHS, num_heads=HEADS,
                             img_size=IMG,
                             window_size=(WS,) * len(DEPTHS),
                             mlp_ratio=MLP_RATIO, layer_scale=LS)
    x_np = gen.normal(0, 1, (2, 3, IMG, IMG)).astype(np.float32)
    xin = jnp.asarray(x_np.transpose(0, 2, 3, 1))
    # compiled: an eager Flax init compiles each primitive on its own
    variables = jax.jit(lambda k, xx: model.init(k, xx, False))(jax.random.PRNGKey(0), xin)
    converted, report = convert_state_dict("gcvit_xxtiny", sd, variables)
    assert not report.missing, report.missing
    assert not report.unused, report.unused

    with torch.no_grad():
        theirs = _gcvit_torch_forward(sd, torch.from_numpy(x_np)).numpy()
    ours = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, False))(converted, xin))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-4)
