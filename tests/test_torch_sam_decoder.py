"""The port's SAM prompt encoder and mask decoder (``tmr_tpu_torch/models/sam_decoder.py``)
against the JAX package's on the CPU, at the tiny size of ``tests/test_sam_refine.py``
(transformer dim 32, 4 heads, MLP 64, an 8 x 8 grid): weights made by the torch oracle
(``tests/oracles_sam.py``), converted by ``tmr_tpu.utils.convert.convert_sam_refiner`` and
put into the port through ``params_from_jax``; inputs from a numpy seed. Also the weight
bridge (a flax ``init_params`` tree), the port's own checkpoint converter
(``utils/convert.sam_refiner_state_dict``) and ``checkpoint_kind``.

Tolerances: embeddings 1e-5 (sin and cos of the same f32 arguments from two math
libraries), masks and IoU 1e-4 x their largest
magnitude (f32 sums in another order through two two-way blocks), the resize 1e-6,
boxes of boolean masks exactly; converted weights bit for bit."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.oracles_sam import MaskDecoderT, PromptEncoderT  # noqa: E402
from tmr_tpu.models.sam_decoder import MaskDecoder as JMaskDecoder  # noqa: E402
from tmr_tpu.models.sam_decoder import PromptEncoder as JPromptEncoder  # noqa: E402
from tmr_tpu.models.sam_decoder import masks_to_boxes as j_masks_to_boxes  # noqa: E402
from tmr_tpu.models.sam_decoder import resize_align_corners as j_resize  # noqa: E402
from tmr_tpu.refine import SamRefineModule as JSamRefineModule  # noqa: E402
from tmr_tpu.utils.convert import convert_sam_refiner  # noqa: E402
from tmr_tpu_torch.models.sam_decoder import (MaskDecoder, PromptEncoder,  # noqa: E402
                                              UpConv2x, masks_to_boxes,
                                              resize_align_corners)
from tmr_tpu_torch.refine import SamRefineModule  # noqa: E402
from tmr_tpu_torch.utils import convert  # noqa: E402
from tmr_tpu_torch.utils.weights import init_params, params_from_jax  # noqa: E402

DIM, HEADS, MLP = 32, 4, 64
GRID = (8, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def oracle_state_dict(seed=0):
    """A SAM-layout refiner state_dict (``prompt_encoder.*`` / ``mask_decoder.*``) of the
    torch oracle at the tiny size."""
    torch.manual_seed(seed)
    pe = PromptEncoderT(embed_dim=DIM, mask_in_chans=16).eval()
    md = MaskDecoderT(dim=DIM, depth=2, num_heads=HEADS, mlp_dim=MLP).eval()
    sd = {f"prompt_encoder.{k}": v for k, v in pe.state_dict().items()}
    sd.update({f"mask_decoder.{k}": v for k, v in md.state_dict().items()})
    return sd, pe, md


def refiner_sam_layout(sd):
    """The inverse of ``convert.sam_refiner_state_dict``: a port refiner state_dict in
    SAM's checkpoint layout (``prompt_encoder.*`` / ``mask_decoder.*``)."""
    out = {}
    for key, val in sd.items():
        part, key = key.split(".", 1)
        if key == "point_embeddings":
            for i in range(val.shape[0]):
                out[f"{part}.point_embeddings.{i}.weight"] = val[i:i + 1]
            continue
        if key in ("not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens"):
            key += ".weight"
        elif key.startswith("upscale_"):
            i, leaf = key[len("upscale_"):].split(".")
            if i in ("0", "3") and leaf == "weight":
                val = val.permute(1, 0, 2, 3)
            key = f"output_upscaling.{i}.{leaf}"
        key = re.sub(r"^mask_down_(\d)\.", r"mask_downscaling.\1.", key)
        key = re.sub(r"^transformer\.layers_(\d+)\.mlp_lin(\d)\.",
                     r"transformer.layers.\1.mlp.lin\2.", key)
        key = re.sub(r"^transformer\.layers_(\d+)\.", r"transformer.layers.\1.", key)
        key = re.sub(r"^hyper_mlps_(\d+)\.layers_(\d+)\.",
                     r"output_hypernetworks_mlps.\1.layers.\2.", key)
        key = re.sub(r"^iou_prediction_head\.layers_(\d+)\.",
                     r"iou_prediction_head.layers.\1.", key)
        out[f"{part}.{key}"] = val.clone()
    return out


def port_modules():
    return (PromptEncoder(DIM), MaskDecoder(DIM, transformer_num_heads=HEADS,
                                            transformer_mlp_dim=MLP))


@pytest.fixture(scope="module")
def pair():
    """The JAX modules, their params (converted from the oracle), and the port's
    refiner loaded through the weight bridge."""
    sd, _, _ = oracle_state_dict()
    params = convert_sam_refiner(sd)
    pe, md = port_modules()
    refiner = SamRefineModule(chunk=4, prompt_encoder=pe, mask_decoder=md)
    refiner.load_state_dict(params_from_jax(params))
    jpe = JPromptEncoder(embed_dim=DIM)
    jmd = JMaskDecoder(transformer_dim=DIM, transformer_num_heads=HEADS,
                       transformer_mlp_dim=MLP)
    return jpe, jmd, params, refiner.eval()


def _boxes(rng, n, size=64):
    b = rng.uniform(0, size * 0.6, (n, 2))
    return np.concatenate([b, b + rng.uniform(4, size * 0.4, (n, 2))], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("image_size", [(64, 64), (256, 192)])
def test_box_embedding_matches_jax(pair, image_size):
    jpe, _, params, ref = pair
    boxes = _boxes(np.random.default_rng(0), 5, max(image_size))
    want = jax.jit(lambda p, b: jpe.apply({"params": p}, b, image_size,
                                          method=JPromptEncoder.embed_boxes))(
        params["prompt_encoder"], boxes)
    got = ref.prompt_encoder.embed_boxes(_t(boxes), image_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    sparse, dense = ref.prompt_encoder(_t(boxes), image_size, GRID)
    assert torch.equal(sparse, got) and dense.shape == (5, *GRID, DIM)


def test_point_embedding_matches_jax(pair):
    """Labels 1 (positive), 0 (negative) and -1 (padding)."""
    jpe, _, params, ref = pair
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 64, (3, 4, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1, 1], [0, 0, 1, -1], [-1, -1, 1, 0]], np.int32)
    want = jax.jit(lambda p, x, y: jpe.apply({"params": p}, x, y, (64, 48),
                                             method=JPromptEncoder.embed_points))(
        params["prompt_encoder"], pts, labels)
    got = ref.prompt_encoder.embed_points(_t(pts), _t(labels), (64, 48))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_mask_embedding_matches_jax(pair):
    jpe, _, params, ref = pair
    masks = np.random.default_rng(2).standard_normal((2, 32, 32, 1)).astype(np.float32)
    want = jax.jit(lambda p, m: jpe.apply({"params": p}, m,
                                          method=JPromptEncoder.embed_masks))(
        params["prompt_encoder"], masks)
    got = ref.prompt_encoder.embed_masks(_t(masks))
    assert got.shape == (2, *GRID, DIM)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("grid", [(8, 8), (6, 10)])
def test_dense_pe_and_no_mask_dense_match_jax(pair, grid):
    jpe, _, params, ref = pair
    want = jpe.apply({"params": params["prompt_encoder"]}, grid,
                     method=JPromptEncoder.dense_pe)
    got = ref.prompt_encoder.dense_pe(grid)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    want = jpe.apply({"params": params["prompt_encoder"]}, 3, grid,
                     method=JPromptEncoder.no_mask_dense)
    np.testing.assert_array_equal(ref.prompt_encoder.no_mask_dense(3, grid).detach().numpy(),
                                  np.asarray(want))


def _decoder_inputs(jpe, params, ref, n, feat_batch, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((feat_batch, *GRID, DIM)).astype(np.float32)
    boxes = _boxes(rng, n)
    pe_p = params["prompt_encoder"]
    sparse, dense = jpe.apply({"params": pe_p}, jnp.asarray(boxes), (64, 64), GRID)
    image_pe = jpe.apply({"params": pe_p}, GRID, method=JPromptEncoder.dense_pe)
    return feats, boxes, (np.asarray(sparse), np.asarray(dense), np.asarray(image_pe))


@pytest.mark.parametrize("return_all,feat_batch", [(False, 1), (False, 3), (True, 1)])
def test_mask_decoder_matches_jax(pair, return_all, feat_batch):
    """The best-IoU mask (or every token's) and the IoU, on one shared feature or one per
    prompt."""
    jpe, jmd, params, ref = pair
    feats, _, (sparse, dense, image_pe) = _decoder_inputs(jpe, params, ref, 3, feat_batch,
                                                          3)
    jmd = jmd.clone(return_all_masks=return_all)
    want_m, want_i = jax.jit(lambda p, *a: jmd.apply({"params": p}, *a))(
        params["mask_decoder"], feats, image_pe, sparse, dense)
    with torch.no_grad():
        got_m, got_i = ref.mask_decoder(_t(feats), _t(image_pe), _t(sparse), _t(dense),
                                        return_all_masks=return_all)
    assert got_m.shape == want_m.shape == ((3, 4, 32, 32) if return_all else (3, 32, 32))
    scale = float(np.abs(np.asarray(want_m)).max())
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(want_i)).max()))


def test_mask_decoder_matches_the_torch_oracle(pair):
    """The same weights in the reference's module tree (NCHW) give the same masks."""
    jpe, _, params, ref = pair
    _, pe_t, md_t = oracle_state_dict()
    feats, boxes, _ = _decoder_inputs(jpe, params, ref, 3, 1, 4)
    with torch.no_grad():
        sparse_t = pe_t.embed_boxes(_t(boxes), (64, 64))
        dense_t = pe_t.no_mask_dense(3, GRID).permute(0, 3, 1, 2)
        grid_t = pe_t.dense_pe(GRID).permute(2, 0, 1)[None]
        want_m, want_i = md_t(_t(feats).permute(0, 3, 1, 2), grid_t, sparse_t, dense_t)
        sparse, dense = ref.prompt_encoder(_t(boxes), (64, 64), GRID)
        got_m, got_i = ref.mask_decoder(_t(feats), ref.prompt_encoder.dense_pe(GRID),
                                        sparse, dense)
    scale = float(want_m.abs().max())
    np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got_i.numpy(), want_i.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out", [((2, 7, 5), (21, 15)), ((1, 8, 8), (32, 32)),
                                       ((3, 32, 32), (64, 48)), ((2, 1, 6), (4, 6))])
def test_resize_align_corners_matches_jax(shape, out):
    """Upsampling, a non-integer factor, a size that stays, a 1-row source (repeated)."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), out))
    got = resize_align_corners(_t(x), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if shape[1] > 1:
        ref = torch.nn.functional.interpolate(_t(x)[None], out, mode="bilinear",
                                              align_corners=True)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_masks_to_boxes_matches_jax():
    rng = np.random.default_rng(6)
    masks = rng.random((6, 16, 20)) > 0.97
    masks[0] = False  # empty
    masks[1] = False
    masks[1, 5, 7] = True  # one pixel
    masks[2] = False
    masks[2, 3:9, 4:12] = True
    want_b, want_n = j_masks_to_boxes(jnp.asarray(masks))
    got_b, got_n = masks_to_boxes(_t(masks))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_b.numpy()[:3], [[0, 0, 0, 0], [7, 5, 7, 5],
                                                      [4, 3, 11, 8]])


def test_upconv_reads_the_bridge_layout():
    """A flax (2, 2, C_in, C_out) kernel through ``params_from_jax`` computes SAM's
    ``ConvTranspose2d`` (kernel 2, stride 2) on NHWC maps."""
    rng = np.random.default_rng(7)
    kernel = rng.standard_normal((2, 2, 6, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    up = UpConv2x(6, 5)
    up.load_state_dict(params_from_jax({"kernel": kernel, "bias": bias}))
    x = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    ct = torch.nn.ConvTranspose2d(6, 5, 2, stride=2)
    with torch.no_grad():
        ct.weight.copy_(_t(kernel.transpose(2, 3, 0, 1)))
        ct.bias.copy_(_t(bias))
        want = ct(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = up(_t(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_params_from_jax_of_an_init_tree_reproduces_the_jax_decoder():
    """A JAX ``SamRefineModule.init_params`` tree (every prompt path materialized, raw
    parameters, flax LayerNorm scales, UpConv2x kernels) loads strictly into the port
    and decodes as the JAX modules do."""
    jref = JSamRefineModule(chunk=4)
    jref.prompt_encoder = JPromptEncoder(embed_dim=DIM)
    jref.mask_decoder = JMaskDecoder(transformer_dim=DIM, transformer_num_heads=HEADS,
                                     transformer_mlp_dim=MLP)
    # SamRefineModule.init_params's own calls, jitted (eager flax init takes ~20 s here)
    params = jax.jit(lambda: jref.init_params(seed=3))()
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    sd = params_from_jax(params)
    for name in ("mask_decoder.transformer.layers_0.norm1.weight",
                 "mask_decoder.transformer.norm_final_attn.weight",
                 "mask_decoder.upscale_1.weight", "prompt_encoder.mask_down_1.weight"):
        assert name in sd, name
    assert sd["mask_decoder.upscale_0.weight"].shape == (DIM // 4, DIM, 2, 2)
    ref = SamRefineModule(chunk=4, prompt_encoder=port_modules()[0],
                          mask_decoder=port_modules()[1])
    ref.load_state_dict(sd, strict=True)
    feats, _, (sparse, dense, image_pe) = _decoder_inputs(
        jref.prompt_encoder, params, ref, 2, 1, 8)
    want_m, want_i = jax.jit(lambda p, *a: jref.mask_decoder.apply({"params": p}, *a))(
        params["mask_decoder"], feats, image_pe, sparse, dense)
    with torch.no_grad():
        got_m, got_i = ref.mask_decoder(_t(feats), _t(image_pe), _t(sparse), _t(dense))
    scale = float(np.abs(np.asarray(want_m)).max())
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-5)


def test_converter_matches_jax_convert_sam_refiner():
    """The port reads a SAM-layout state dict straight into the refiner's keys: equal,
    key for key and bit for bit, to the bridge of the JAX converter's tree; the extra
    keys of a full checkpoint are ignored."""
    sd, _, _ = oracle_state_dict(1)
    want = params_from_jax(convert_sam_refiner({k: v.numpy() for k, v in sd.items()}))
    full = dict(sd, **{"image_encoder.pos_embed": torch.zeros(1, 2, 2, 3),
                       "mask_decoder.hf_token.weight": torch.ones(1, DIM)})
    got = convert.sam_refiner_state_dict(full)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    SamRefineModule(prompt_encoder=port_modules()[0],
                    mask_decoder=port_modules()[1]).load_state_dict(got, strict=True)


@pytest.mark.parametrize("keys,kind", [
    (("prompt_encoder.no_mask_embed.weight", "mask_decoder.iou_token.weight"),
     "sam_refiner"),
    (("image_encoder.pos_embed", "prompt_encoder.no_mask_embed.weight",
      "mask_decoder.iou_token.weight"), "sam_vit"),
    (("model.input_proj.0.weight",), "matching_net")])
def test_checkpoint_kind_names_the_refiner_layout(keys, kind):
    """The refiner's subtrees alone are the refiner's layout; a full SAM checkpoint
    (encoder too) stays the encoder's, whose file the refiner reads as well."""
    assert convert.checkpoint_kind({k: torch.zeros(1) for k in keys}) == kind


def test_seeded_init_covers_every_decoder_parameter():
    """``init_params`` draws the raw parameters N(0, 1) and the UpConv2x kernels
    lecun-normal (fan-in 4 C_in), deterministically from the seed."""
    a, b = (SamRefineModule(prompt_encoder=port_modules()[0],
                            mask_decoder=port_modules()[1]) for _ in range(2))
    init_params(a, 5)
    init_params(b, 5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    md = a.mask_decoder
    for p in (md.iou_token, md.mask_tokens, a.prompt_encoder.point_embeddings,
              a.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix):
        assert 0.5 < float(p.detach().std()) < 1.6
    w = md.upscale_0.weight.detach()
    assert abs(float(w.std()) * (4 * DIM) ** 0.5 - 1.0) < 0.2
    assert float(md.upscale_0.bias.detach().abs().max()) == 0.0


def test_sam_layout_round_trips_through_the_converter():
    """The oracle's SAM-layout state dict -> the port's keys -> back: the same tensors."""
    sd, _, _ = oracle_state_dict(2)
    back = refiner_sam_layout(convert.sam_refiner_state_dict(sd))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k].float()) for k in sd)
