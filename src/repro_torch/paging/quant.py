"""Quantized KV pages of the port — the counterpart of
``repro.paging.quant``.

Quantization is symmetric per (token row, kv head): each row of each page
carries its own f32 scale (``amax / 127``; an all-zero row gets 1.0), so
appending one token during decode quantizes only that token's row and
existing codes and scales are never rescaled. The scales live with their
page: copy-on-write and prefix sharing move codes and scales together.
``torch.round`` rounds half to even like ``jnp.round``, so codes and
scales equal ``repro``'s bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Int8Pages", "quantize_rows", "dequantize_rows"]

INT8_MAX = 127.0


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 quantization over the trailing (head_dim) axis:
    x (..., hd) float -> (codes (..., hd) int8, scales (...) float32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX,
                        INT8_MAX)
    return codes.to(torch.int8), scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_rows``: (..., hd) int8 + (...) f32 -> float."""
    return (codes.float() * scales[..., None].float()).to(dtype)


@dataclasses.dataclass(frozen=True)
class Int8Pages:
    """int8 K or V pages with per-(token row, kv head) scales.

    codes:  (n_pages, page_size, KV, hd) int8
    scales: (n_pages, page_size, KV)     float32

    The two tensors are written in place by the page pool and the paged
    decode step; the container itself never changes.
    """

    codes: torch.Tensor
    scales: torch.Tensor

    @classmethod
    def zeros(cls, shape, device="cpu") -> "Int8Pages":
        """Zeroed pages (scale 1.0) for a (n_pages, ps, KV, hd) shape."""
        return cls(codes=torch.zeros(shape, dtype=torch.int8, device=device),
                   scales=torch.ones(shape[:-1], dtype=torch.float32,
                                     device=device))

    @classmethod
    def quantize(cls, x: torch.Tensor) -> "Int8Pages":
        codes, scales = quantize_rows(x)
        return cls(codes=codes, scales=scales)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize_rows(self.codes, self.scales, dtype)

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes + self.scales.nbytes)

    def __repr__(self) -> str:
        return f"Int8Pages(shape={self.shape})"
