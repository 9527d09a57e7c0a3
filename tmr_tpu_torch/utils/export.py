"""Serialized inference artifacts (counterpart of ``tmr_tpu/utils/export.py``, the
reference's ONNX hop: ``export_onnx.py`` -> onnxruntime in ``mapper.py:40-45``).

An artifact is a ``torch.export`` program written with ``torch.export.save`` (``.pt2``):
the graph of ATen ops and the port's registered kernel ops (``tmr::global_attn``,
``tmr::window_attn``, ``tmr::xcorr``, ``tmr::xcorr_int8``, ``tmr::nms``, ``tmr::int8_mm``,
``tmr::int8_conv3x3``; ``ops/cuda_*.py``) with the weights inside. A worker that loads one
needs no model code and no weights, only the port's ops package, whose import registers
the ops and whose kernels are built from ``csrc/`` at their first launch.

- :func:`export_encoder`: the SAM encoder, ``(b, S, S, 3)`` f32 NHWC -> features
  ``(b, S/16, S/16, C)`` f32 NHWC (the JAX artifact's layout), ``b`` symbolic;
- :func:`export_detector`: the Predictor's own program (``Predictor._get_fn`` or
  ``_get_multi_batched_fn``: one copy, traced), ``(image, exemplars[, k_real]) ->
  (boxes, scores, valid)``, batch and template capacity static;
- :func:`export_sam_decoder`: ``sam.SamDeployDecoder``'s call, the prompt count ``n``
  symbolic.

The programs are not decomposed (no ``run_decompositions()``): they run the ATen ops the
eager model runs (``aten.linear`` stays ``aten.linear``) and the same kernels, so an
artifact's outputs equal the eager model's bit for bit on the same device.

Devices: a program records the device it was traced on. :func:`load_exported` puts it
on the card unless ``device="cpu"`` is asked for, and raises without one; a program
traced on another device is moved with ``torch.export.passes.move_to_device_pass``. An
artifact traced on the card holds its weights there, so it loads only where there is a
card.
"""

from __future__ import annotations

import gc
import importlib
from typing import Callable, Optional, Tuple

import torch

#: the modules whose import registers the ``tmr::`` ops
OP_MODULES = ("cuda_attn", "cuda_xcorr", "cuda_nms", "cuda_int8", "probe")


def register_ops() -> None:
    """Import every module that registers a ``tmr::`` op (a loaded program calls them by
    name)."""
    for name in OP_MODULES:
        importlib.import_module(f"tmr_tpu_torch.ops.{name}")


class _Program(torch.nn.Module):
    """``fn`` as the forward of a module that owns ``modules``, so that ``torch.export``
    lifts their weights into the program (``fn`` reaches them through its closure)."""

    def __init__(self, fn: Callable, **modules: torch.nn.Module):
        super().__init__()
        for name, module in modules.items():
            setattr(self, name, module)
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn: Callable, modules: dict, args: tuple, dynamic_shapes=None):
    """``fn(*args)`` as a program; ``dynamic_shapes`` one entry per argument."""
    register_ops()
    with torch.no_grad():
        # the forward's one parameter, *args, takes the per-argument entries
        program = torch.export.export(
            _Program(fn, **modules), args,
            dynamic_shapes=None if dynamic_shapes is None else (dynamic_shapes,))
    _collect()
    return program


def _collect() -> None:
    """Free the reference cycles a trace or a load leaves (fake tensors, graphs, shape
    environments) at once. Left to the collector, they cost the calls that follow: a
    detector artifact traced and loaded in the same process ran at 0.33-0.57 s a call in
    place of ~0.03 until a full collection had run (PERF.md, export)."""
    gc.collect()


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def export_encoder(model: torch.nn.Module, image_size: int = 1024, channels: int = 3,
                   dynamic_batch: bool = True, batch: int = 1):
    """The encoder ``model`` (a ``SamViT``, eval mode) as a program: images ``(b, S, S,
    channels)`` f32 NHWC -> its features f32 NHWC, traced on the model's device. With
    ``dynamic_batch`` (the reference's dynamic batch axis, export_onnx.py:85-88) ``b`` is
    symbolic, so one artifact serves every batch size; else it is ``batch``."""
    from tmr_tpu_torch.models.vit import nhwc_features

    def encode(images):
        return nhwc_features(model, images)

    # a batch of 2 to trace with: torch.export specializes a dimension it sees at 1
    b = 2 if dynamic_batch else batch
    images = torch.zeros((b, image_size, image_size, channels), dtype=torch.float32,
                         device=_device_of(model))
    dims = ({0: torch.export.Dim("b")},) if dynamic_batch else None
    return _export(encode, {"encoder": model}, (images,), dims)


def export_detector(predictor, capacity: int, image_size: int = 1024, batch: int = 1,
                    n_exemplars: int = 1):
    """The whole detector as a program: the Predictor's own pipeline (encoder, matcher,
    heads, decode, NMS; the eager call's code, traced), with every ``Config`` flag its
    eager program honours, the int8 arms included, and the weights inside. Traced on the
    predictor's device.

    The batch and the template ``capacity`` are static, as in the JAX artifact: the live
    Predictor picks a capacity bucket per request (``pick_capacity``), so export one
    artifact per bucket and route by exemplar span on the serving host.

    ``n_exemplars == 1``: ``(image (batch, S, S, 3), exemplars (batch, 1, 4)) -> (boxes,
    scores, valid)``. ``n_exemplars > 1``: the multi-exemplar program (a decode per
    exemplar row, one NMS over their union), ``(image (1, S, S, 3), exemplars (K, 4),
    k_real () int32) -> (boxes, scores, valid)``, the rows past ``k_real`` masked; for
    slot-exact parity with ``predict_multi_exemplar`` take ``n_exemplars`` from
    ``Predictor.K_BUCKETS`` and pad the rows as it does (with the last real row).

    Raises ``NotImplementedError`` under ``cfg.refine_box`` with a refiner: the SAM
    refiner gathers the valid slots with ``torch.nonzero``, a data-dependent size that a
    program cannot carry (ROADMAP A7)."""
    if predictor.refiner is not None and predictor.cfg.refine_box:
        raise NotImplementedError(
            "export_detector: cfg.refine_box with a refiner is not exportable: the SAM "
            "refiner gathers the valid slots with torch.nonzero, a data-dependent size "
            "(ROADMAP A7, export of the refined detector)")
    device = predictor.device
    image = torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32,
                        device=device)
    if n_exemplars == 1:
        fn = predictor._get_fn(capacity)

        def serve(image, exemplars):
            dets = fn(image, exemplars)
            return dets["boxes"], dets["scores"], dets["valid"]

        args = (image, torch.full((batch, 1, 4), 0.5, device=device))
    else:
        if batch != 1:
            raise ValueError("the multi-exemplar program is per image (batch 1), as "
                             "predict_multi_exemplar is")
        mfn = predictor._get_multi_batched_fn(capacity, n_exemplars)

        def serve(image, exemplars, k_real):
            dets = mfn(image, exemplars[None], k_real.reshape(1))
            return dets["boxes"], dets["scores"], dets["valid"]

        args = (image, torch.full((n_exemplars, 4), 0.5, device=device),
                torch.tensor(n_exemplars, dtype=torch.int32, device=device))
    return _export(serve, {"model": predictor.model}, args)


def export_sam_decoder(deploy, embed_hw: Tuple[int, int], num_points: int = 2,
                       orig_im_size: Tuple[int, int] = (1024, 1024),
                       dynamic_prompts: bool = True, n_prompts: int = 1):
    """``deploy`` (a ``sam.SamDeployDecoder``, the reference's ``SamOnnxModel``
    surface) as a program on its Sam's device. Its five inputs mirror the ONNX export's:
    ``(image_embeddings (1, h, w, C), point_coords (n, P, 2), point_labels (n, P) int32,
    mask_input (n, 4h, 4w, 1), has_mask_input (n,))``; the prompt count ``n`` is symbolic
    with ``dynamic_prompts`` (the ONNX dynamic axis), else ``n_prompts``. The points per
    prompt and the output size are static."""
    sam = deploy.sam
    h, w = embed_hw
    dim = sam.prompt_encoder.embed_dim
    device = _device_of(sam.mask_decoder)

    def decode(image_embeddings, point_coords, point_labels, mask_input, has_mask_input):
        return deploy(image_embeddings, point_coords, point_labels, mask_input,
                      has_mask_input, tuple(orig_im_size))

    # trace at 2 prompts: torch.export specializes a dimension it sees at 1
    n = 2 if dynamic_prompts else n_prompts
    f32 = dict(dtype=torch.float32, device=device)
    args = (torch.zeros((1, h, w, dim), **f32), torch.zeros((n, num_points, 2), **f32),
            torch.ones((n, num_points), dtype=torch.int32, device=device),
            torch.zeros((n, 4 * h, 4 * w, 1), **f32), torch.zeros((n,), **f32))
    dims = None
    if dynamic_prompts:
        dn = torch.export.Dim("n")
        dims = (None, {0: dn}, {0: dn}, {0: dn}, {0: dn})
    return _export(decode, {"prompt_encoder": sam.prompt_encoder,
                            "mask_decoder": sam.mask_decoder}, args, dims)


def save_exported(program, path: str) -> None:
    """Write a program to ``path`` (``torch.export.save``; the port's extension is
    ``.pt2``)."""
    torch.export.save(program, path)


def _program_device(program) -> Optional[torch.device]:
    for t in (*program.state_dict.values(), *program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def load_program(path: str, device=None):
    """The ``torch.export`` program at ``path`` on ``device`` (the card unless
    ``"cpu"`` is asked for; raises without a card). A program traced on another device
    is moved there (``torch.export.passes.move_to_device_pass``)."""
    from tmr_tpu_torch.models import resolve_device

    target = resolve_device(device)
    register_ops()
    program = torch.export.load(path)
    here = _program_device(program)
    if here is not None and (here.type, here.index or 0) != (target.type,
                                                              target.index or 0):
        try:
            from torch.export.passes import move_to_device_pass
        except ImportError as err:
            raise RuntimeError(
                f"{path} was exported on {here}; moving it to {target} needs "
                f"torch.export.passes.move_to_device_pass, which torch "
                f"{torch.__version__} lacks: export it on {target}") from err
        program = move_to_device_pass(program, str(target))
    _collect()
    return program


def load_exported(path: str, device=None) -> Callable:
    """An artifact as a plain callable: ``(images) -> features`` for
    :func:`export_encoder`'s, ``(image, exemplars[, k_real]) -> (boxes, scores, valid)``
    for :func:`export_detector`'s, the decoder's five inputs -> its outputs for
    :func:`export_sam_decoder`'s. It runs on ``device`` (:func:`load_program`) under
    ``inference_mode``.

    A worker needs the port's ops package (``tmr_tpu_torch.ops``, imported here: its
    import registers the ``tmr::`` ops the program calls, and its kernels build from
    ``csrc/`` at their first launch), but no model code and no weights."""
    module = load_program(path, device).module()

    @torch.inference_mode()
    def call(*args):
        return module(*args)

    return call


#: a detector or decoder artifact loads the same way: a positional-args callable
load_exported_detector = load_exported_decoder = load_exported


def exported_input_spec(path: str):
    """(shape, dtype) of the artifact's first input, for feeder-side validation: a
    symbolic batch entry reads ``"b"`` (the JAX artifact's symbol)."""
    register_ops()
    program = torch.export.load(path)
    spec = next(s for s in program.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)
    val = next(n for n in program.graph.nodes
               if n.op == "placeholder" and n.name == spec.arg.name).meta["val"]
    return tuple(d if isinstance(d, int) else "b" for d in val.shape), val.dtype
