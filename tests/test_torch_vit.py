"""Port SAM ViT (``tmr_tpu_torch/models/vit.py``) vs ``tmr_tpu/models/vit.py`` on the
same numpy inputs and the same flax-initialised weights (through the weight bridge).

All in f32 (the algorithm check); tolerances 1e-5 for table lookups and layout ops
(exact up to float rounding), 1e-4 for whole blocks and the encoder (matmul and
softmax sums in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.models import vit as jvit  # noqa: E402
from tmr_tpu_torch.models import vit  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)
#: ViT-H's head dim (1280 / 16 = 80) at TINY's depth and layout
TINY_H80 = dict(TINY, embed_dim=160)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _randomize_tables(params, rng):
    """The flax init zeroes the rel-pos tables and pos_embed; give them values."""
    def walk(node):
        for name, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
                node[name] = (rng.standard_normal(np.shape(val)) * 0.3).astype(np.float32)
    walk(params)
    return params


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.mark.parametrize("q_size,table_len", [(14, 27), (64, 127), (96, 127), (7, 27)])
def test_get_rel_pos_matches_jax(q_size, table_len):
    table = np.random.default_rng(q_size).standard_normal((table_len, 8)).astype(np.float32)
    want = np.asarray(jvit.get_rel_pos(q_size, q_size, jnp.asarray(table)))
    got = vit.get_rel_pos(q_size, q_size, torch.from_numpy(table)).numpy()
    assert got.shape == (q_size, q_size, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,window", [(10, 11, 3), (14, 14, 14), (64, 64, 14)])
def test_window_partition_roundtrip_matches_jax(h, w, window):
    x = np.random.default_rng(h).standard_normal((2, h, w, 4)).astype(np.float32)
    want, want_pad = jvit.window_partition(jnp.asarray(x), window)
    got, pad = vit.window_partition(torch.from_numpy(x), window)
    assert pad == want_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = vit.window_unpartition(got, window, pad, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("dim,heads,grid,window", [
    (32, 2, 6, 0), (32, 2, 6, 3),  # tiny: global and windowed (padded windows)
    (768, 12, 14, 0), (768, 12, 14, 14),  # ViT-B width on a small grid
])
def test_block_matches_jax(dim, heads, grid, window):
    rng = np.random.default_rng(dim + window)
    x = rng.standard_normal((2, grid, grid, dim)).astype(np.float32)
    jblock = jvit.Block(num_heads=heads, window_size=window, rel_pos_size=(grid, grid))
    params = _randomize_tables(_np_tree(
        jblock.init(jax.random.key(0), jnp.asarray(x))["params"]), rng)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = vit.Block(dim, heads, 4.0, window, (grid, grid))
    block.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [32, 48])  # native grid, and the resized grid
def test_sam_vit_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = jvit.SamViT(pretrain_img_size=32, **TINY)
    params = _randomize_tables(_np_tree(
        jmodel.init(jax.random.key(1), jnp.asarray(x))["params"]), rng)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = vit.SamViT(pretrain_img_size=32, **TINY)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [32, 48])  # native grid, and the resized grid
def test_sam_vit_head_dim_80_matches_jax(size):
    """A ViT with ViT-H's head dim (80: embed 160 over 2 heads), global blocks 1 and 3."""
    rng = np.random.default_rng(size + 80)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = jvit.SamViT(pretrain_img_size=32, **TINY_H80)
    params = _randomize_tables(_np_tree(
        jmodel.init(jax.random.key(2), jnp.asarray(x))["params"]), rng)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = vit.SamViT(pretrain_img_size=32, **TINY_H80)
    assert model.blocks[0].attn.rel_pos_h.shape[-1] == 80
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
