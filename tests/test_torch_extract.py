"""The port's ``extract_feature`` and ``build_sam_encoder`` against the JAX package's on
the same image and weights.

TINY encoder at 32^2 (as ``tests/test_torch_mapreduce.py``), the JAX weights brought
across by ``params_from_jax``. Tolerances: statistics and features within 1e-4 x the
largest |value| (the port's f32 encoder parity bound); the verdict, shapes and dtypes
exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import extract_feature as jext  # noqa: E402
import tmr_tpu.models  # noqa: E402
import tmr_tpu_torch.models  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu_torch import extract_feature as ext  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
            out_chans=8, pretrain_img_size=32)
SIZE = 32
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def encoders():
    jmodel = JSamViT(**TINY)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(1)
    for blk in params.values():  # the flax init zeroes the tables and pos_embed
        if isinstance(blk, dict) and "attn" in blk:
            for name in ("rel_pos_h", "rel_pos_w"):
                blk["attn"][name] = (rng.standard_normal(blk["attn"][name].shape)
                                     * 0.3).astype(np.float32)
    params["pos_embed"] = (rng.standard_normal(params["pos_embed"].shape)
                           * 0.3).astype(np.float32)
    model = SamViT(**TINY)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model.eval()


def _write_png(path, shape, seed):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    Image.fromarray(img).save(path)
    return str(path)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", [(24, 40, 3), (50, 20, 3)])
def test_extraction_matches_jax(encoders, tmp_path, shape, capsys):
    jmodel, params, model = encoders
    path = _write_png(tmp_path / "img.png", shape, sum(shape))
    want = jext.run_extraction_and_analyze(path, str(tmp_path / "jax"), model=jmodel,
                                           params=params, image_size=SIZE)
    jax_out = capsys.readouterr().out
    got = ext.run_extraction_and_analyze(path, str(tmp_path / "port"), model=model,
                                         image_size=SIZE)
    port_out = capsys.readouterr().out
    for key in ("mean", "std", "max", "sparsity"):
        assert abs(got[key] - want[key]) <= TOL * max(abs(want["max"]), 1.0), key
    assert ext.verdict(got["mean"]) == jext.verdict(want["mean"])
    feats, jfeats = np.load(got["save_path"]), np.load(want["save_path"])
    assert feats.dtype == np.float32 and feats.shape == (1, 2, 2, TINY["out_chans"])
    _close(feats, jfeats)
    assert os.path.basename(got["save_path"]) == "img_feature.npy"
    # the same report lines, numbers and output directories aside
    port_out = port_out.replace(str(tmp_path / "port"), "OUT")
    jax_out = jax_out.replace(str(tmp_path / "jax"), "OUT")
    strip = lambda s: [ln.split(":")[0] for ln in s.splitlines() if "encoding" not in ln]  # noqa: E731
    assert strip(port_out) == strip(jax_out)


def test_missing_image_becomes_the_dummy(encoders, tmp_path, capsys):
    jmodel, params, model = encoders
    want = jext.run_extraction_and_analyze(str(tmp_path / "none.jpg"), str(tmp_path / "j"),
                                           model=jmodel, params=params, image_size=SIZE)
    got = ext.run_extraction_and_analyze(str(tmp_path / "none.jpg"), str(tmp_path / "p"),
                                         model=model, image_size=SIZE)
    assert "not found" in capsys.readouterr().out
    assert os.path.basename(got["save_path"]) == "test_image_feature.npy"
    _close(np.load(got["save_path"]), np.load(want["save_path"]))
    img, name = ext.load_or_dummy(str(tmp_path / "none.jpg"))
    assert img.shape == (720, 1280, 3) and img.dtype == np.uint8 and not img.any()


def test_analyze_and_verdict_match_jax():
    rng = np.random.default_rng(2)
    for f in (rng.standard_normal((1, 4, 4, 8)).astype(np.float32),
              np.zeros((1, 2, 2, 3), np.float32)):
        assert ext.analyze(f) == jext.analyze(f)
    for mean in (0.0, 0.0129, 0.0130, 0.0135, 0.0137, 0.0138, 1.0, -1.0):
        assert ext.verdict(mean) == jext.verdict(mean)


def _sam_checkpoint(model, path, prefix):
    """The TINY port encoder's weights in the SAM checkpoint layout (the inverse of
    ``convert.sam_vit_state_dict``'s renames)."""
    renames = {"patch_embed.": "patch_embed.proj.", "neck_0.": "neck.0.",
               "neck_1.": "neck.1.", "neck_2.": "neck.2.", "neck_3.": "neck.3."}
    sd = {}
    for key, val in model.state_dict().items():
        for mine, theirs in renames.items():
            if key.startswith(mine):
                key = theirs + key[len(mine):]
        sd[prefix + key] = val.clone()
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = torch.zeros(2, 2)
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("prefix", ["image_encoder.", ""])
def test_build_sam_encoder_loads_a_checkpoint_like_jax(encoders, tmp_path, monkeypatch,
                                                       prefix):
    _, _, model = encoders
    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_vit",
                        lambda kind, dtype: SamViT(**TINY, dtype=dtype))
    monkeypatch.setattr(tmr_tpu.models, "build_sam_vit",
                        lambda kind, dtype: JSamViT(**TINY, dtype=dtype))
    ckpt = _sam_checkpoint(model, tmp_path / "sam.pth", prefix)
    got = tmr_tpu_torch.models.build_sam_encoder("sam_vit_b", ckpt, dtype=torch.float32,
                                                 device="cpu")
    assert not got.training
    for key, val in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[key], val, rtol=0, atol=0)
    jmodel, jparams = tmr_tpu.models.build_sam_encoder("vit_b", ckpt, SIZE,
                                                       dtype=jnp.float32)
    img = np.random.default_rng(3).random((1, SIZE, SIZE, 3), np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(img)))
    with torch.inference_mode():
        out = got(torch.from_numpy(img)).permute(0, 2, 3, 1).numpy()
    _close(out, want)


def test_build_sam_encoder_aliases_seed_and_device(monkeypatch):
    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_vit",
                        lambda kind, dtype: SamViT(**dict(TINY, depth={
                            "vit_b": 2, "vit_h": 3}[kind]), dtype=dtype))
    for alias, depth in (("sam", 3), ("sam_vit_h", 3), ("vit_h", 3), ("sam_vit_b", 2),
                         ("vit_b", 2)):
        enc = tmr_tpu_torch.models.build_sam_encoder(alias, device="cpu")
        assert len(enc.blocks) == depth and not enc.training
        assert enc.patch_embed.compute_dtype == torch.bfloat16
    a = tmr_tpu_torch.models.build_sam_encoder("vit_b", device="cpu")
    b = tmr_tpu_torch.models.build_sam_encoder("vit_b", device="cpu")
    for key, val in a.state_dict().items():
        assert torch.equal(val, b.state_dict()[key])
    assert a.blocks[0].attn.rel_pos_h.abs().sum() > 0  # seeded tables do real work
    with pytest.raises(KeyError, match="unknown SAM encoder"):
        tmr_tpu_torch.models.build_sam_encoder("resnet50", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmr_tpu_torch.models.build_sam_encoder("vit_b")


def test_cli_runs_vit_b_on_the_cpu_when_asked(tmp_path, capsys):
    stats = ext.main([str(tmp_path / "none.jpg"), "--output_dir", str(tmp_path / "f"),
                      "--device", "cpu", "--image_size", "32"])
    feats = np.load(stats["save_path"])
    assert feats.shape == (1, 2, 2, 256) and feats.dtype == np.float32
    assert np.isfinite(feats).all()
    assert "VERDICT" in capsys.readouterr().out
    # --artifact on a TINY exported encoder: the dump equals the model's, bit for bit
    from tmr_tpu_torch.models.vit import SamViT
    from tmr_tpu_torch.utils.export import export_encoder, save_exported
    from tmr_tpu_torch.utils.weights import init_params

    tiny = SamViT(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
                  window_size=2, out_chans=8, pretrain_img_size=32)
    init_params(tiny, 0)
    tiny.eval()
    save_exported(export_encoder(tiny, image_size=32), str(tmp_path / "enc.pt2"))
    want = ext.run_extraction_and_analyze(str(tmp_path / "none.jpg"), str(tmp_path / "m"),
                                          model=tiny, image_size=32)
    got = ext.main([str(tmp_path / "none.jpg"), "--output_dir", str(tmp_path / "a"),
                    "--artifact", str(tmp_path / "enc.pt2"), "--device", "cpu",
                    "--image_size", "32"])
    assert np.array_equal(np.load(got["save_path"]), np.load(want["save_path"]))
    assert got["mean"] == want["mean"] and got["sparsity"] == want["sparsity"]
