"""The weight bridge (flax param tree -> the port's state_dict) and the port's seeded
random init. Exact comparisons: the bridge only transposes and renames."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.utils.weights import init_params, params_from_jax  # noqa: E402

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tiny_port():
    cfg = preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32")
    return build_model(cfg, backbone=SamViT(pretrain_img_size=32, **TINY), device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=32, **TINY), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=9)
    params = jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, 32, 32, 3)),
                                  jnp.array([[[0.4, 0.4, 0.6, 0.6]]]))["params"]
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def test_bridge_covers_every_parameter(jax_params):
    sd = params_from_jax(jax_params)
    model = _tiny_port()
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    model.load_state_dict(sd)  # strict


def test_bridge_transposes_and_renames(jax_params):
    sd = params_from_jax(jax_params)
    qkv = jax_params["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["backbone.blocks.0.attn.qkv.weight"].numpy(), qkv.T)
    conv = jax_params["decoder_o_0"]["conv_0"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["decoder_o_0.conv_0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    patch = jax_params["backbone"]["patch_embed"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.patch_embed.weight"].numpy(),
                                  patch.transpose(3, 2, 0, 1))
    norm = jax_params["backbone"]["blocks_2"]["norm2"]["scale"]
    np.testing.assert_array_equal(sd["backbone.blocks.2.norm2.weight"].numpy(), norm)
    np.testing.assert_array_equal(sd["matcher.scale"].numpy(),
                                  jax_params["matcher"]["scale"])
    np.testing.assert_array_equal(sd["backbone.pos_embed"].numpy(),
                                  jax_params["backbone"]["pos_embed"])


def test_init_params_is_seeded_and_shaped():
    a, b, c = _tiny_port(), _tiny_port(), _tiny_port()
    init_params(a, 7)
    init_params(b, 7)
    init_params(c, 8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    w = sa["backbone.blocks.0.mlp.lin1.weight"]
    assert not torch.equal(w, sc["backbone.blocks.0.mlp.lin1.weight"])
    # lecun-normal, cut at 2 std: std ~ 1/sqrt(fan_in) * 0.88/0.88
    assert 0.7 < float(w.std()) * np.sqrt(w.shape[1]) < 1.3
    assert float(sa["objectness_head_0.conv.weight"].std()) < 0.02
    assert float(sa["backbone.blocks.1.attn.rel_pos_h"].abs().max()) > 0
    assert torch.equal(sa["matcher.scale"], torch.ones(1))
    assert torch.equal(sa["backbone.blocks.0.norm1.weight"], torch.ones(32))
    assert torch.equal(sa["input_proj_0.bias"], torch.zeros(16))
