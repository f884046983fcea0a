"""Input stand-ins for every (arch × input-shape) cell: ``device="meta"``
tensors, shapes and dtypes with no storage (the reference's
``ShapeDtypeStruct``s).  The dry-run traces against them, and
``chip_smoke.py``'s train phases cut their shapes from ``SHAPES``.

    train_4k     seq 4,096   global_batch 256   (train_step)
    prefill_32k  seq 32,768  global_batch 32    (prefill / encode)
    decode_32k   kv 32,768   global_batch 128   (serve_step, 1 new token)
    long_500k    kv 524,288  global_batch 1     (serve_step, 1 new token)

Skips: encoder-only archs have no decode; pure full-attention archs skip
long_500k.

The shapes are the reference's.  The dtypes are the port's own batch
convention, the one ``SyntheticLM`` hands the steps through
``torch.from_numpy``: tokens, labels and ``positions3`` int32 (as the
reference's), ``loss_mask`` and ``vision_mask`` bool (the reference's
``bool_``), and the stub frontends' ``features`` and ``vision_embeds``
float32 where the reference declares bfloat16 (the model casts them to the
step's dtype on entry, as it does the corpus's).  The cache is the port's
``init_cache`` on meta: K / V and the conv taps in the serving dtype
(bfloat16), the recurrent states fp32, ``pos`` int32, ``t`` a Python int.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import ModelConfig, init_cache


def _spec(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    cell = SHAPES[shape_name]
    if cell.step == "decode":
        if not cfg.supports_decode():
            return False, "encoder-only: no decode step"
        if cell.name == "long_500k" and not cfg.long_context_ok():
            return False, "full attention: long_500k needs sub-quadratic attn"
    return True, ""


def batch_specs(cfg: ModelConfig, seq_len: int, batch: int,
                *, training: bool) -> dict:
    """Meta tensors for one train / prefill batch."""
    out = {"tokens": _spec((batch, seq_len), torch.int32)}
    if training:
        out["labels"] = _spec((batch, seq_len), torch.int32)
    if cfg.modality == "audio_stub":
        out["features"] = _spec((batch, seq_len, 512), torch.float32)
        if training:
            out["loss_mask"] = _spec((batch, seq_len), torch.bool)
    if cfg.modality == "vision_stub":
        n_img = min(cfg.frontend_tokens or 1024, seq_len // 2)
        out["vision_embeds"] = _spec((batch, n_img, cfg.d_model),
                                     torch.float32)
        out["vision_mask"] = _spec((batch, seq_len), torch.bool)
        out["positions3"] = _spec((3, batch, seq_len), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def decode_token_specs(batch: int) -> torch.Tensor:
    return _spec((batch, 1), torch.int32)


def cell_tokens(shape_name: str) -> int:
    cell = SHAPES[shape_name]
    if cell.step == "decode":
        return cell.global_batch          # one new token per sequence
    return cell.global_batch * cell.seq_len
