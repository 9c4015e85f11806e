"""Streaming top-k retrieval on the device: the port of the single-device half
of ``plip_tpu.ops.retrieval``.

The index is scanned in chunks of rows: each chunk's ``[Q, chunk]`` scores
(an fp32 matmul, or an int8 dot with int32 sums) fold into a running
``[Q, k]`` best, so the full ``[Q, N]`` score matrix never exists. The work
was XLA in the reference, not a Pallas kernel; here it is PyTorch ops on the
index's device.

Order: scores descending, and exact ties earliest index first, as
``lax.top_k`` (stable) ranks them in the JAX package. ``torch.topk`` gives
no tie order, so each candidate is ranked by one int64 key: the score's bits
mapped to an order-preserving int32 in the high half, ``2^31 - 1 - row`` in
the low half. Keys are unique, their order is (score, earlier row), and a
top-k of keys is the stable top-k of scores.

``merge`` is accepted as in the JAX package, but both values take the exact
merge: ``lax.approx_max_k`` has no torch counterpart, and the exact top-k
(a recall of 1) is within the "approx" contract. The dp-sharded (mesh) half
of the JAX module is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_LOW = 0x7FFFFFFF


def _keys(scores: torch.Tensor, row0: int) -> torch.Tensor:
    """``[Q, C]`` fp32 scores of rows ``row0 ..`` -> their int64 rank keys."""
    bits = (scores + 0.0).view(torch.int32)  # + 0.0: -0.0 ranks as +0.0
    ordered = torch.where(bits < 0, bits ^ _LOW, bits).to(torch.int64)
    low = _LOW - torch.arange(row0, row0 + scores.shape[1], device=scores.device)
    return (ordered << 32) | low


def _unkey(keys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """int64 rank keys -> (rows int32, scores fp32) on the host."""
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ _LOW, ordered)
    rows = (_LOW - (keys & 0xFFFFFFFF)).to(torch.int32)
    return rows.cpu().numpy(), bits.view(torch.float32).cpu().numpy()


def _merge(best: Optional[torch.Tensor], keys: torch.Tensor, k: int) -> torch.Tensor:
    cat = keys if best is None else torch.cat([best, keys], dim=1)
    return cat.topk(k, dim=1).values


def _check_merge(merge: str) -> None:
    if merge not in ("exact", "approx"):
        raise ValueError(f"unknown merge {merge!r}")


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _scan_f32(q, index, k: int, chunk: int, n_valid: int,
              normalize_rows: bool) -> torch.Tensor:
    """The stream over ``index`` rows: the ``[Q, k]`` best keys. Rows at or
    past ``n_valid`` score -inf."""
    best = None
    for r0 in range(0, index.shape[0], chunk):
        rows = index[r0:r0 + chunk]
        if normalize_rows:
            rows = _normalized(rows)
        scores = torch.matmul(q, rows.T)
        if r0 + rows.shape[0] > n_valid:
            ids = torch.arange(r0, r0 + rows.shape[0], device=q.device)
            scores = torch.where(ids[None, :] < n_valid, scores, -torch.inf)
        best = _merge(best, _keys(scores, r0), k)
    return best


def cosine_topk(query_vectors, index_vectors, k: int = 10, normalize=True,
                chunk: int = 8192, merge: str = "exact",
                n_valid: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k cosine-similarity retrieval, on the device the index lies on (a
    numpy index is scanned on the CPU).

    normalize: True/"both" L2-normalizes queries and rows (cosine);
        "queries" the queries only (the reference PLIP API's ranking); False
        raw dots. Norms are floored at 1e-12.
    chunk: index rows per step (bounds the ``[Q, chunk]`` scores).
    merge: "exact" or "approx" (both exact here; see the module).
    n_valid: the real leading rows of an index pre-padded with zero rows.

    Returns (indices ``[Q, k]`` int32, scores ``[Q, k]`` fp32), descending,
    exact ties earliest index first.
    """
    x = torch.as_tensor(index_vectors)
    q = torch.as_tensor(query_vectors, dtype=torch.float32, device=x.device)
    x = x.to(torch.float32)
    n = x.shape[0] if n_valid is None else int(n_valid)
    if n == 0:  # empty corpus: the host path's [Q, 0]
        return (np.zeros((q.shape[0], 0), np.int32), np.zeros((q.shape[0], 0), np.float32))
    k = min(k, n)
    if normalize in (True, "both", "queries"):
        q = _normalized(q)
    _check_merge(merge)
    chunk = max(k, min(chunk, x.shape[0]))
    with torch.no_grad():
        best = _scan_f32(q, x, k, chunk, n, normalize in (True, "both"))
    return _unkey(best)


def quantize_rows(index_vectors, normalize: bool = True):
    """Per-row symmetric int8 quantization of a retrieval index (numpy, the
    JAX package's function as it is).

    Returns ``(q_rows [N, D] int8, inv_scales [N] fp32)`` with
    ``rows ~ q_rows * inv_scales[:, None]``; each row's scale is
    ``127 / max|row|``.
    """
    x = np.asarray(index_vectors, np.float32)
    if normalize:
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    amax = np.maximum(np.abs(x).max(axis=-1), 1e-12)
    scales = 127.0 / amax
    q = np.clip(np.rint(x * scales[:, None]), -127, 127).astype(np.int8)
    return q, (1.0 / scales).astype(np.float32)


def int8_operand(a: torch.Tensor) -> torch.Tensor:
    """``a`` (int8 ``[M, D]``) as ``int8_dot``'s first operand. On CUDA
    ``torch._int_mm`` needs more than 16 rows there and D a multiple of 8:
    ``a`` gets zero rows and columns up to them (its dots are sliced off by
    the caller); on the CPU it is returned as it is."""
    if not a.is_cuda:
        return a
    M, D = a.shape
    m_pad = max(17, M) + (-max(17, M)) % 8 - M
    return torch.nn.functional.pad(a, (0, (-D) % 8, 0, m_pad)) if m_pad or D % 8 else a


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of int8 ``[M, D']`` (``int8_operand(x)``) and ``[N, D]``
    in exact int32 sums (``torch._int_mm``): ``[M, N]``. ``b`` gets zero
    columns up to D' and, on CUDA, zero rows up to a multiple of 8 (a short
    last chunk, a small corpus)."""
    N, D = b.shape
    n_pad = (-N) % 8 if b.is_cuda else 0
    if n_pad or a.shape[1] != D:
        b = torch.nn.functional.pad(b, (0, a.shape[1] - D, 0, n_pad))
    out = torch._int_mm(a, b.T)
    return out[:, :N] if n_pad else out


def _scan_int8(q_i8, q_inv, index_i8, row_inv, m: int, chunk: int,
               n_valid: int) -> torch.Tensor:
    """The int8 stream over ``int8_operand`` queries: int32 dots dequantized
    as ``idot * q_inv * inv_s`` (in that order; a pad query's ``q_inv`` is
    0), then ``_scan_f32``'s merge. The best ``m`` keys of each query row."""
    best = None
    for r0 in range(0, index_i8.shape[0], chunk):
        rows = index_i8[r0:r0 + chunk]
        idot = int8_dot(q_i8, rows)
        scores = idot.float() * q_inv[:, None] * row_inv[r0:r0 + chunk][None, :]
        if r0 + rows.shape[0] > n_valid:
            ids = torch.arange(r0, r0 + rows.shape[0], device=q_i8.device)
            scores = torch.where(ids[None, :] < n_valid, scores, -torch.inf)
        best = _merge(best, _keys(scores, r0), m)
    return best


def cosine_topk_int8(query_vectors, index_i8, row_inv_scales, k: int = 10,
                     normalize_queries: bool = True, chunk: int = 8192,
                     oversample: int = 4, rescore_vectors=None, merge: str = "auto",
                     n_valid: Optional[int] = None, auto_oversample: bool = True):
    """Streaming top-k over an int8 index (``quantize_rows``), on the device
    the index lies on.

    Queries are quantized per row on the host. With ``rescore_vectors`` (the
    fp32 rows on the host, preprocessed as the rows given to
    ``quantize_rows`` were), the best ``oversample * k`` quantized candidates
    are scored again exactly on the host and the top-k is their exact
    ranking. ``auto_oversample`` then probes the candidate boundary: unless
    no excluded row can reach rank k (excluded quantized scores are at most
    the last candidate's, and the quantization error is bounded by twice its
    largest on the candidates), the stream runs once more with twice the
    margin, and if the probe trips again the result is
    the exact fp32 ``cosine_topk`` over ``rescore_vectors``.

    ``merge``: "auto", "exact" or "approx" (all exact here; see the
    module). ``n_valid``: the real leading rows of a pre-padded index.

    Returns (indices ``[Q, k]`` int32, scores ``[Q, k]`` fp32) descending;
    exact fp32 dots when rescoring, quantized estimates otherwise.
    """
    q = np.asarray(query_vectors, np.float32)
    if normalize_queries:
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    index_i8 = torch.as_tensor(index_i8)
    dev = index_i8.device
    n = index_i8.shape[0] if n_valid is None else int(n_valid)
    if n == 0:
        return (np.zeros((q.shape[0], 0), np.int32), np.zeros((q.shape[0], 0), np.float32))
    k = min(k, n)
    m = min(max(oversample * k, k), n) if rescore_vectors is not None else k

    # per-query symmetric int8 quantization
    q_amax = np.maximum(np.abs(q).max(axis=-1), 1e-12)
    q_i8 = np.clip(np.rint(q * (127.0 / q_amax)[:, None]), -127, 127).astype(np.int8)
    q_inv = (q_amax / 127.0).astype(np.float32)
    if merge != "auto":
        _check_merge(merge)
    q_i8 = int8_operand(torch.as_tensor(q_i8, device=dev))
    q_inv_t = torch.zeros(q_i8.shape[0], dtype=torch.float32, device=dev)
    q_inv_t[:len(q)] = torch.as_tensor(q_inv, device=dev)
    row_inv = torch.as_tensor(row_inv_scales, dtype=torch.float32, device=dev)

    xr = None if rescore_vectors is None else np.asarray(rescore_vectors, np.float32)
    raised = False
    while True:
        ck = max(m, min(chunk, index_i8.shape[0]))
        with torch.no_grad():
            best = _scan_int8(q_i8, q_inv_t, index_i8, row_inv, m, ck, n)[:len(q)]
        idxs, vals = _unkey(best)
        if xr is None:
            return idxs, vals

        # exact host rescore of the oversampled candidates
        cand = xr[np.clip(idxs, 0, n - 1)]  # [Q, m, D]; the clip guards pads
        exact = np.einsum("qd,qmd->qm", q, cand).astype(np.float32)
        exact = np.where(idxs >= 0, exact, -np.inf)
        order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        result = (np.take_along_axis(idxs, order, axis=1),
                  np.take_along_axis(exact, order, axis=1))
        if not auto_oversample:
            return result
        if m >= n:
            return result  # the candidate set was the whole corpus

        # the candidate-boundary probe (see the docstring)
        fin = np.isfinite(exact) & np.isfinite(vals)
        eps_q = 2.0 * np.where(fin, np.abs(exact - vals), 0.0).max(axis=1)
        if np.all(vals[:, -1] + eps_q < result[1][:, -1]):
            return result
        if not raised:
            raised = True
            m = int(min(max(2 * m, m + k), n))
            continue
        return cosine_topk(q, torch.as_tensor(xr[:n], device=dev), k=k, normalize=False,
                           chunk=chunk, merge="exact")
