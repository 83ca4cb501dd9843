"""Block normalization and the normalize-then-auto search for BC1, BC2 and BC3, on the
device, in plain PyTorch.

Counterpart of ``dxt_lossless_transform_tpu/oracle/normalize.py:32-222`` (the
normalization, which the JAX package runs in numpy on the host) together with
``dxt_lossless_transform_tpu/ops/normalize.py:150-246`` (the transforms and the
search). Normalization rewrites blocks that have many equivalent encodings into one
canonical form, so that the byte stream repeats more: it is visually lossless, not
bit-lossless, and a transformed file untransforms to the *normalized* file. The
payload is copied to the device once, decoded there by :mod:`.decode`, and each
mode's normalized words are a few ``torch.where`` of the original words with masks
from that one decode; the bytes equal the JAX oracle's.

- BC1: a block of 16 identical transparent pixels becomes all ``0xFF``; a block of 16
  identical opaque pixels whose colour survives 8888 -> 565 -> 8888 becomes
  ``[c565, 0, indices 0]`` (``COLOR0_ONLY``) or ``[c565, c565, indices 0]``
  (``REPLICATE_COLOR``).
- BC2: the colour section alone, under the same test with alpha ignored.
- BC3: alpha first: a block of uniform alpha v becomes ``[v, 0, indices 0]``
  (``UNIFORM_ALPHA_ZERO_INDICES``); an opaque one all ``0xFF`` (``OPAQUE_FILL_ALL``)
  or ``[0, 0, indices 7]`` (``OPAQUE_ZERO_ALPHA_MAX_INDICES``), which write the
  uniform form for the other uniform blocks; then the colour section as BC2.

The search (:func:`transform_bc1_auto_with_normalization` and its BC2 and BC3
twins) runs the port's auto-search (:mod:`.auto`) on each mode's normalized payload
where it lies, scores the winner's output on the regions the JAX package's
``_scored_auto`` reads, exactly (int64 for LTU), and keeps the first mode with the
smallest score; only the winner's bytes come back. Inputs that are empty, shorter
than a block or not whole blocks give the JAX package's result or its exception
type.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .. import backend
from ..estimate.base import SizeEstimation
from ..settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
)
from . import auto as ops_auto, bc1 as ops_bc1, bc2 as ops_bc2, bc3 as ops_bc3
from . import decode


class ColorNormalizationMode(enum.IntEnum):
    """BC1/BC2/BC3 canonical forms of a solid-colour block."""

    NONE = 0
    COLOR0_ONLY = 1
    REPLICATE_COLOR = 2

    @staticmethod
    def all_values():
        return (ColorNormalizationMode.NONE, ColorNormalizationMode.COLOR0_ONLY,
                ColorNormalizationMode.REPLICATE_COLOR)


class AlphaNormalizationMode(enum.IntEnum):
    """BC3 canonical forms of a uniform-alpha block."""

    NONE = 0
    UNIFORM_ALPHA_ZERO_INDICES = 1
    OPAQUE_FILL_ALL = 2
    OPAQUE_ZERO_ALPHA_MAX_INDICES = 3

    @staticmethod
    def all_values():
        return tuple(AlphaNormalizationMode)


CM = ColorNormalizationMode
AM = AlphaNormalizationMode
_ALL_ONES = -1  # 0xFFFFFFFF as int32
_OPAQUE_MAX_INDICES = -(1 << 16)  # 0xFFFF0000 as int32: a0 = a1 = 0, indices all 7


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 words with those bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# --- one decode per payload: the blocks each mode rewrites -----------------------------

def _solid(planes: torch.Tensor, channels: int) -> tuple:
    """(solid, c565): blocks whose 16 pixels are identical in the first ``channels``
    channels and whose first pixel's colour survives 8888 -> 565 -> 8888, and that
    colour as RGB565."""
    first = planes[:, :, 0]
    identical = (planes[:channels] == first[:channels, :, None]).all(dim=2).all(dim=0)
    c565 = decode.from_rgb(first[0], first[1], first[2])
    roundtrip = (decode.to_rgba8888(c565)[:, :3] == first[:3].T).all(dim=1)
    return identical & roundtrip, c565


def _analyse_bc1(words: torch.Tensor) -> dict:
    planes = decode.decode_bc1(words)
    first_alpha = planes[3, :, 0]
    identical = (planes == planes[:, :, :1]).all(dim=2).all(dim=0)
    transparent = identical & (first_alpha == 0)
    solid, c565 = _solid(planes, 4)
    # BC1 demands an opaque colour to round-trip
    return {"transparent": transparent,
            "solid": solid & ~transparent & (first_alpha == 255), "c565": c565}


def _analyse_bc2(words: torch.Tensor) -> dict:
    solid, c565 = _solid(decode.decode_bc2(words), 3)
    return {"solid": solid, "c565": c565}


def _analyse_bc3(words: torch.Tensor) -> dict:
    planes = decode.decode_bc3(words)
    solid, c565 = _solid(planes, 3)
    alpha = planes[3]
    uniform = (alpha == alpha[:, :1]).all(dim=1)
    value = alpha[:, 0]
    return {"solid": solid, "c565": c565, "uniform": uniform, "value": value,
            "opaque": uniform & (value == 255)}


def _colour_word(c565: torch.Tensor, mode: ColorNormalizationMode) -> torch.Tensor:
    if mode == CM.COLOR0_ONLY:
        return c565
    return _i32(c565.to(torch.int64) * 0x10001)


def _write_colour(words: torch.Tensor, a: dict, mode: ColorNormalizationMode,
                  col: int) -> None:
    """Solid blocks' colour word (column ``col``) and index word (``col + 1``)."""
    solid = a["solid"]
    words[:, col] = torch.where(solid, _colour_word(a["c565"], mode), words[:, col])
    words[:, col + 1] = torch.where(solid, 0, words[:, col + 1])


def _apply_bc1(words: torch.Tensor, a: dict, mode: ColorNormalizationMode) -> torch.Tensor:
    out = words.clone()
    out[:] = torch.where(a["transparent"][:, None], _ALL_ONES, out)
    _write_colour(out, a, mode, 0)
    return out


def _apply_bc2(words: torch.Tensor, a: dict, mode: ColorNormalizationMode) -> torch.Tensor:
    out = words.clone()
    _write_colour(out, a, mode, 2)
    return out


def _apply_bc3(words: torch.Tensor, a: dict, amode: AlphaNormalizationMode,
               cmode: ColorNormalizationMode) -> torch.Tensor:
    out = words.clone()
    if amode != AM.NONE:
        opaque = a["opaque"]
        # the opaque-only modes write the uniform form for the other uniform blocks
        uni = a["uniform"] if amode == AM.UNIFORM_ALPHA_ZERO_INDICES \
            else a["uniform"] & ~opaque
        out[:, 0] = torch.where(uni, a["value"], out[:, 0])
        out[:, 1] = torch.where(uni, 0, out[:, 1])
        if amode != AM.UNIFORM_ALPHA_ZERO_INDICES:
            w0 = _ALL_ONES if amode == AM.OPAQUE_FILL_ALL else _OPAQUE_MAX_INDICES
            out[:, 0] = torch.where(opaque, w0, out[:, 0])
            out[:, 1] = torch.where(opaque, _ALL_ONES, out[:, 1])
    if cmode != CM.NONE:
        _write_colour(out, a, cmode, 2)
    return out


class _Format(NamedTuple):
    block_size: int
    analyse: Callable  # words -> the masks of one decode
    apply: Callable  # (words, masks, *modes) -> normalized words
    ops: object  # the format's transform module


_FORMATS = {
    "BC1": _Format(8, _analyse_bc1, _apply_bc1, ops_bc1),
    "BC2": _Format(16, _analyse_bc2, _apply_bc2, ops_bc2),
    "BC3": _Format(16, _analyse_bc3, _apply_bc3, ops_bc3),
}


def _is_none(modes: tuple) -> bool:
    return all(m == 0 for m in modes)


def _normalize_words(fmt: str, words: torch.Tensor, modes: tuple) -> torch.Tensor:
    if _is_none(modes):
        return words.clone()
    f = _FORMATS[fmt]
    return f.apply(words, f.analyse(words), *modes)


def normalize_words_bc1(words: torch.Tensor, color_mode) -> torch.Tensor:
    """int32[N, 2] BC1 block words (on any device) -> the normalized words."""
    return _normalize_words("BC1", words, (CM(color_mode),))


def normalize_words_bc2(words: torch.Tensor, color_mode) -> torch.Tensor:
    """int32[N, 4] BC2 block words -> the normalized words (alpha untouched)."""
    return _normalize_words("BC2", words, (CM(color_mode),))


def normalize_words_bc3(words: torch.Tensor, alpha_mode, color_mode) -> torch.Tensor:
    """int32[N, 4] BC3 block words -> the normalized words."""
    return _normalize_words("BC3", words, (AM(alpha_mode), CM(color_mode)))


# --- bytes ----------------------------------------------------------------------------

def _upload_blocks(data, block_size: int, dev: torch.device) -> torch.Tensor:
    """Whole blocks on ``dev`` as int32 words; a length that is no whole number of
    blocks raises :class:`ValueError`, as the JAX oracle's reshape does."""
    if len(data) % block_size:
        raise ValueError(f"data length {len(data)} is not a multiple of the "
                         f"{block_size}-byte block")
    return decode.words(backend.upload(data, dev), block_size // 4)


def _download(words: torch.Tensor) -> bytes:
    return backend.download(words.reshape(-1).view(torch.uint8)) if words.numel() else b""


def _normalize_bytes(fmt: str, data, modes: tuple, device) -> bytes:
    """NONE takes any bytes as they are, as in JAX; every other mode whole blocks."""
    dev = backend.resolve_device(device)
    if _is_none(modes):
        return bytes(data)
    words = _upload_blocks(data, _FORMATS[fmt].block_size, dev)
    return _download(_normalize_words(fmt, words, modes))


def normalize_blocks_bc1(data, color_mode,
                         device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize BC1 bytes on ``device``."""
    return _normalize_bytes("BC1", data, (CM(color_mode),), device)


def normalize_blocks_bc2(data, color_mode,
                         device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize BC2 bytes on ``device`` (the colour section only)."""
    return _normalize_bytes("BC2", data, (CM(color_mode),), device)


def normalize_blocks_bc3(data, alpha_mode, color_mode,
                         device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize BC3 bytes on ``device``."""
    return _normalize_bytes("BC3", data, (AM(alpha_mode), CM(color_mode)), device)


def _colour_grid(color_modes=None) -> list:
    return [(CM(m),) for m in (color_modes if color_modes is not None
                               else CM.all_values())]


def _bc3_grid(alpha_modes=None, color_modes=None) -> list:
    return [(AM(am), cm) for am in (alpha_modes if alpha_modes is not None
                                    else AM.all_values())
            for (cm,) in _colour_grid(color_modes)]


def _all_modes(fmt: str, data, grid: list, device) -> dict:
    """{mode tuple: normalized bytes} from one upload and one decode."""
    f = _FORMATS[fmt]
    words = _upload_blocks(data, f.block_size, backend.resolve_device(device))
    a = f.analyse(words)
    return {modes: bytes(data) if _is_none(modes) else _download(f.apply(words, a, *modes))
            for modes in grid}


def normalize_blocks_all_modes_bc1(data, device: Union[str, torch.device] = "cuda") -> dict:
    """{mode: normalized bytes} for every :class:`ColorNormalizationMode`, from one
    upload and one decode."""
    return {m: out for (m,), out in _all_modes("BC1", data, _colour_grid(), device).items()}


def normalize_blocks_all_modes_bc2(data, device: Union[str, torch.device] = "cuda") -> dict:
    """{mode: normalized bytes} for every :class:`ColorNormalizationMode`."""
    return {m: out for (m,), out in _all_modes("BC2", data, _colour_grid(), device).items()}


def normalize_blocks_all_modes_bc3(data, device: Union[str, torch.device] = "cuda") -> dict:
    """{(alpha_mode, color_mode): normalized bytes} over the 4 x 3 grid."""
    return _all_modes("BC3", data, _bc3_grid(), device)


# --- split lanes, in place ---------------------------------------------------------------

def normalize_split_blocks_in_place_bc1(colors: torch.Tensor, indices: torch.Tensor,
                                        color_mode) -> None:
    """Normalize BC1 lanes in place: ``colors`` and ``indices`` are the int32 words
    of each block (the standard layout, colours not decorrelated), on one device."""
    mode = CM(color_mode)
    if mode == CM.NONE:
        return
    out = normalize_words_bc1(torch.stack([colors, indices], dim=1), mode)
    colors.copy_(out[:, 0])
    indices.copy_(out[:, 1])


def normalize_split_blocks_in_place_bc2(alpha: torch.Tensor, colors: torch.Tensor,
                                        indices: torch.Tensor, color_mode) -> None:
    """Normalize BC2 lanes in place: ``alpha`` int64 (each block's 8 alpha bytes as a
    little-endian u64, untouched), ``colors`` and ``indices`` int32 words."""
    mode = CM(color_mode)
    if mode == CM.NONE:
        return
    lo = _i32(alpha & 0xFFFFFFFF)
    hi = _i32((alpha >> 32) & 0xFFFFFFFF)
    out = normalize_words_bc2(torch.stack([lo, hi, colors, indices], dim=1), mode)
    colors.copy_(out[:, 2])
    indices.copy_(out[:, 3])


def normalize_split_blocks_in_place_bc3(alpha_ep: torch.Tensor, alpha_idx: torch.Tensor,
                                        colors: torch.Tensor, cidx: torch.Tensor,
                                        alpha_mode, color_mode) -> None:
    """Normalize BC3 lanes in place: ``alpha_ep`` (N,) and ``alpha_idx`` (N, 3) hold
    16-bit values (each block's bytes 0-1 and 2-7 as little-endian u16s) in an integer
    dtype, ``colors`` and ``cidx`` int32 words."""
    amode, cmode = AM(alpha_mode), CM(color_mode)
    if amode == AM.NONE and cmode == CM.NONE:
        return
    h = [t.to(torch.int64) & 0xFFFF for t in (alpha_ep, *alpha_idx.unbind(1))]
    w0 = _i32(h[0] | (h[1] << 16))
    w1 = _i32(h[2] | (h[3] << 16))
    out = normalize_words_bc3(torch.stack([w0, w1, colors, cidx], dim=1), amode, cmode)
    o0 = out[:, 0].to(torch.int64) & 0xFFFFFFFF
    o1 = out[:, 1].to(torch.int64) & 0xFFFFFFFF
    alpha_ep.copy_(o0 & 0xFFFF)
    alpha_idx.copy_(torch.stack([o0 >> 16, o1 & 0xFFFF, o1 >> 16], dim=1))
    colors.copy_(out[:, 2])
    cidx.copy_(out[:, 3])


# --- normalize, then transform ------------------------------------------------------------

def _transform_normalized(fmt: str, data, settings, modes: tuple, device) -> bytes:
    f = _FORMATS[fmt]
    dev = backend.resolve_device(device)
    if _is_none(modes) or not len(data):
        return f.ops.transform(data, settings, dev)
    words = _normalize_words(fmt, _upload_blocks(data, f.block_size, dev), modes)
    return backend.download(f.ops.transform_tensor(words.reshape(-1).view(torch.uint8),
                                                   settings))


def transform_bc1_with_normalize_blocks(data, settings: Bc1TransformSettings, color_mode,
                                        device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize, then transform with ``settings``, on ``device``."""
    return _transform_normalized("BC1", data, settings, (CM(color_mode),), device)


def transform_bc2_with_normalize_blocks(data, settings: Bc2TransformSettings, color_mode,
                                        device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize, then transform with ``settings``, on ``device``."""
    return _transform_normalized("BC2", data, settings, (CM(color_mode),), device)


def transform_bc3_with_normalize_blocks(data, settings: Bc3TransformSettings, alpha_mode,
                                        color_mode,
                                        device: Union[str, torch.device] = "cuda") -> bytes:
    """Normalize, then transform with ``settings``, on ``device``."""
    return _transform_normalized("BC3", data, settings, (AM(alpha_mode), CM(color_mode)),
                                 device)


# --- the search over settings x normalization modes ------------------------------------------

def _region_score(estimator: SizeEstimation, regions) -> Union[int, float]:
    """The estimator's scores of the uint8 device ``regions``, summed, as the JAX
    package's ``_scored_auto`` computes them."""
    return sum(estimator.estimate_batch_device(r.reshape(1, -1), r.numel())[0].item()
               for r in regions)


def _search(fmt: str, data, estimator: SizeEstimation, cand, grid: Sequence[tuple],
            regions, device) -> tuple:
    """Run the auto-search on each mode tuple of ``grid``'s normalized payload and
    keep the first with the smallest score of ``regions(output, len(data))``; returns
    ``(output, settings, *modes)``. One upload and one decode serve every mode."""
    f = _FORMATS[fmt]
    dev = backend.resolve_device(device)
    x = analysis = best = None
    empty = torch.zeros(0, dtype=torch.uint8, device=dev)
    for modes in grid:
        if _is_none(modes):  # the payload as it is
            if ops_auto.start(fmt, data, f.block_size, dev) is None:
                payload = None
            else:
                x = backend.upload(data, dev) if x is None else x
                payload = x
        else:
            if analysis is None:
                words = _upload_blocks(data, f.block_size, dev) if x is None else \
                    decode.words(x, f.block_size // 4)
                analysis = (words, f.analyse(words))
            words, a = analysis
            payload = f.apply(words, a, *modes).view(-1).view(torch.uint8)
        if payload is None or not payload.numel():
            out, settings = empty, cand[-1]
        else:
            out, settings = ops_auto.transform_auto_tensor(fmt, payload, estimator, cand)
        score = _region_score(estimator, regions(out, len(data)))
        if best is None or score < best[3]:
            best = (out, settings, modes, score)
    out, settings, modes, _ = best
    return (backend.download(out) if out.numel() else b"", settings, *modes)


def transform_bc1_auto_with_normalization(
        data, estimator: SizeEstimation, use_all_decorrelation_modes: bool = False,
        color_modes: Optional[Sequence] = None,
        device: Union[str, torch.device] = "cuda",
) -> Tuple[bytes, Bc1TransformSettings, ColorNormalizationMode]:
    """Search settings x colour normalization modes; returns ``(output, settings,
    mode)``. The untransform needs ``settings`` alone: normalization is not
    reversed."""
    cand = (BC1_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
            else BC1_FAST_CANDIDATES)
    # the colour half of the output
    return _search("BC1", data, estimator, cand, _colour_grid(color_modes),
                   lambda out, n: [out[: n // 2]], device)


def transform_bc2_auto_with_normalization(
        data, estimator: SizeEstimation, use_all_decorrelation_modes: bool = False,
        color_modes: Optional[Sequence] = None,
        device: Union[str, torch.device] = "cuda",
) -> Tuple[bytes, Bc2TransformSettings, ColorNormalizationMode]:
    """BC2 search over settings x colour normalization modes; returns ``(output,
    settings, mode)``."""
    cand = (BC2_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
            else BC2_FAST_CANDIDATES)
    # the colour stream: n/4 bytes at n/2 in every BC2 layout
    return _search("BC2", data, estimator, cand, _colour_grid(color_modes),
                   lambda out, n: [out[n // 2: n // 2 + n // 4]], device)


def transform_bc3_auto_with_normalization(
        data, estimator: SizeEstimation, use_all_decorrelation_modes: bool = False,
        alpha_modes: Optional[Sequence] = None, color_modes: Optional[Sequence] = None,
        device: Union[str, torch.device] = "cuda",
):
    """BC3 search over settings x alpha modes x colour modes; returns ``(output,
    settings, alpha_mode, color_mode)``."""
    cand = (BC3_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
            else BC3_FAST_CANDIDATES)
    # the alpha endpoints [0, 2B) and the colours [8B, 12B) of B blocks
    return _search("BC3", data, estimator, cand, _bc3_grid(alpha_modes, color_modes),
                   lambda out, n: [out[: 2 * (n // 16)], out[8 * (n // 16): 12 * (n // 16)]],
                   device)
