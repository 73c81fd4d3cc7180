"""Paged KV cache of the port: ``PagePool`` (global fixed-size pages, free
list + refcounts, all-or-nothing admission, on-demand growth,
copy-on-write), ``PrefixCache`` (chained-hash shared-prefix page reuse),
``Int8Pages`` (int8 pages with per-row scales) and the paged
decode-attention kernel with its plain version (``paging.kernels``,
dispatched through ``repro_torch.kernels.ops.paged_decode_attention``).

The serving engine selects it with ``ContinuousScheduler(...,
cache="paged")``; the dense slot pool stays the A/B baseline.
"""
from repro_torch.paging.pages import Admission, PagePool, tree_nbytes
from repro_torch.paging.prefix import PrefixCache, page_keys
from repro_torch.paging.quant import Int8Pages

__all__ = ["PagePool", "Admission", "PrefixCache", "Int8Pages",
           "page_keys", "tree_nbytes"]
