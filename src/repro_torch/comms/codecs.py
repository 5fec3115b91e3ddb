"""Model-exchange codecs — counterpart of `repro.comms.codecs` (the
``CODECS`` registry behind ``FLConfig.codec``).

The port's cohort is already one flat (m, P) float32 buffer in the
reference's ravel order (core/cohort.py, convert.py), so every codec
works on flat rows against the base row ``convert.ravel(global_tree)``
(or, with ``stacked_base``, one base row per cohort row):

  identity     the rows pass through verbatim (``{"trees": rows}``).
  delta        lossless: the WRAPPING int32 difference of the float bit
               patterns, ``rows.view(int32) - base.view(int32)``; decode
               adds it back and views the sum as float32, so any value
               (inf, nan, -0.0, subnormals) reconstructs bit for bit.
               Every leaf of the port's trees is float32, so the
               reference's integer-leaf branch (a plain integer subtract)
               has no counterpart here.
  delta_int8   lossy: ``rows - base`` in float32, zero-padded to
               Ppad = `flat_width`, quantized by ``ops.q8_encode_flat``
               (one float32 scale per BQ = 256 parameters) with the
               error-feedback (EF) residual folded in first; decode is
               ``base + ops.q8_decode_flat(codes, scales)[:, :P]``. The
               residual lives in ``FLState.comms`` as one
               (vehicles_per_round, Ppad) float32 slot array, slot i =
               cohort position i, as in the reference.

Payloads are dicts of tensors with the reference's shapes and dtypes, so
`payload_nbytes` gives its byte counts: int32 deltas (m, P); int8 codes
(m, Ppad) plus float32 scales (m, Ppad / 256).

The aggregation never runs in delta space: `roundtrip_cohort` hands the
aggregators the decoded rows, so the lossless codecs are bitwise equal
to the identity round.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.convert import (flat_spec, leaves_with_paths, ravel,
                                 tree_map, unravel)
from repro_torch.core.collectives import all_gather_rows
from repro_torch.kernels import ops
from repro_torch.kernels.qdelta import BQ

# --------------------------------------------------------------------------
# byte accounting
# --------------------------------------------------------------------------


def tree_nbytes(tree) -> int:
    """Total bytes of a tree of tensors (numel x element size per leaf)."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in leaves_with_paths(tree))


def payload_nbytes(payload) -> int:
    """Wire bytes of an encoded payload (a dict of tensors)."""
    return tree_nbytes(payload)


def flat_width(tree) -> int:
    """Raveled width P of ONE model tree, rounded up to the quantization
    block BQ — the per-row error-feedback slot width Ppad."""
    p = sum(leaf.numel() for _, leaf in leaves_with_paths(tree))
    return -(-p // BQ) * BQ


def _ravel_rows(stacked) -> torch.Tensor:
    """Stacked tree (every leaf (m, ...)) -> one (m, P) float32 matrix."""
    leaves = [leaf for _, leaf in leaves_with_paths(stacked)]
    m = leaves[0].shape[0]
    return torch.cat([leaf.reshape(m, -1).float() for leaf in leaves], 1)


# --------------------------------------------------------------------------
# codec implementations: rows (m, P) float32, base (P,) or (m, P)
# --------------------------------------------------------------------------

def _identity_encode(rows, base, ef=None):
    return {"trees": rows}, None


def _identity_decode(payload, base):
    return payload["trees"]


def _delta_encode(rows, base, ef=None):
    """Wrapping int32 subtract of the bit patterns: decode's add undoes it
    bit for bit, with no float rounding anywhere."""
    return {"delta": rows.view(torch.int32) - base.view(torch.int32)}, None


def _delta_decode(payload, base):
    return (base.view(torch.int32) + payload["delta"]).view(torch.float32)


def _int8_encode(rows, base, ef=None):
    m, p = rows.shape
    flat = torch.empty((m, -(-p // BQ) * BQ), dtype=torch.float32,
                       device=rows.device)
    torch.sub(rows, base, out=flat[:, :p])
    flat[:, p:].zero_()
    if ef is None:
        ef = torch.zeros_like(flat)
    codes, scales, new_ef = ops.q8_encode_flat(flat, ef)
    return {"codes": codes, "scales": scales}, new_ef


def _int8_decode(payload, base):
    p = base.shape[-1]
    return base + ops.q8_decode_flat(payload["codes"], payload["scales"])[:, :p]


def _no_state(cfg, tree):
    return None


def _int8_init_state(cfg, tree):
    """Zero error-feedback residual: one slot per cohort position, on the
    tree's device."""
    device = leaves_with_paths(tree)[0][1].device
    return {"ef": torch.zeros((cfg.vehicles_per_round, flat_width(tree)),
                              dtype=torch.float32, device=device)}


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Codec:
    """One exchange codec.

    encode(rows, base, ef=None) -> (payload, new_ef) — ROW-WISE: row i of
        every output depends only on row i of the inputs. `rows` is
        (m, P) float32; `base` is one (P,) row broadcast over them, or
        (m, P); `ef` is the (m, Ppad) residual for stateful codecs, else
        None.
    decode(payload, base) -> (m, P) float32 rows; bitwise the encoded
        rows for lossless codecs.
    init_state(cfg, tree) -> the round-0 ``FLState.comms`` (None when the
        codec carries no cross-round state).
    """

    name: str
    lossless: bool
    stateful: bool
    encode: Callable[..., Any]
    decode: Callable[..., Any]
    init_state: Callable[..., Optional[dict]]


CODECS = {
    "identity": Codec("identity", lossless=True, stateful=False,
                      encode=_identity_encode, decode=_identity_decode,
                      init_state=_no_state),
    "delta": Codec("delta", lossless=True, stateful=False,
                   encode=_delta_encode, decode=_delta_decode,
                   init_state=_no_state),
    "delta_int8": Codec("delta_int8", lossless=False, stateful=True,
                        encode=_int8_encode, decode=_int8_decode,
                        init_state=_int8_init_state),
}


def comms_init_state(cfg, tree) -> Optional[dict]:
    """The round-0 ``FLState.comms`` for cfg.codec."""
    return CODECS[cfg.codec].init_state(cfg, tree)


def resolve_codec(codec) -> Codec:
    """A `Codec` from a registry name or a `Codec` instance."""
    return CODECS[codec] if isinstance(codec, str) else codec


# --------------------------------------------------------------------------
# snapshot framing (the serving tier's single-tree payloads)
# --------------------------------------------------------------------------

def encode_snapshot(codec, tree, base):
    """ONE model tree framed through a cohort codec: row 0 of a length-1
    cohort, encoded against ``base`` (the tree the fetching vehicle
    already holds; ignored by ``identity``) with a zero residual. The
    identity framing is the tree itself with a length-1 leading axis
    (views, no copy), as in the reference, so a full payload decodes
    with no base at all. See the reference's docstring for why lossy
    snapshots chain off the served reconstruction."""
    codec = resolve_codec(codec)
    if codec.name == "identity":
        return {"trees": tree_map(lambda t: t[None], tree)}
    payload, _ = codec.encode(ravel(tree)[None], ravel(base))
    return payload


def decode_snapshot(codec, payload, base):
    """Invert `encode_snapshot`: the vehicle-side reconstruction, a tree
    laid out as ``base`` (bitwise the published tree for lossless
    codecs). Its leaves are views into one fresh flat row."""
    codec = resolve_codec(codec)
    if codec.name == "identity":
        return tree_map(lambda t: t[0], payload["trees"])
    rows = codec.decode(payload, ravel(base))
    return unravel(rows[0], flat_spec(base))


# --------------------------------------------------------------------------
# the CohortBatch encode/decode stage
# --------------------------------------------------------------------------

def _roundtrip_shard(codec, cohort, b, comms, rows):
    if cohort.size != cohort.n:
        raise ValueError(f"a sharded cohort goes through the codec without "
                         f"padding rows; got {cohort.n} valid of "
                         f"{cohort.size}")
    lo, hi = cohort.row0, cohort.row0 + cohort.flat.shape[0]
    ef = None
    if codec.stateful:
        full_ef = comms["ef"]
        slots = (torch.arange(cohort.n, device=full_ef.device) if rows is None
                 else torch.as_tensor(rows, dtype=torch.long,
                                      device=full_ef.device))
        ef = full_ef[slots[lo:hi]]
    payload, new_ef = codec.encode(cohort.flat, b, ef)
    cohort = dataclasses.replace(cohort, flat=codec.decode(payload, b))
    if codec.stateful:
        full_ef = full_ef.clone()
        full_ef[slots] = all_gather_rows(new_ef)
        comms = {"ef": full_ef}
    return cohort, comms


def roundtrip_cohort(cfg, cohort, base, comms, rows=None,
                     stacked_base=False):
    """Encode -> decode the cohort's VALID rows against the model tree
    `base` (a stacked tree, one row per valid client, with
    ``stacked_base=True``). Returns (cohort', comms').

    rows: index array mapping cohort row -> error-feedback slot (numpy,
    or an int64 tensor on the residual's device, used with no copy);
    None means slots [0, n) in order. The decoded rows go into a new (m, P)
    buffer; padding rows (m > n) repeat the last decoded row, as in the
    reference (they are masked out of every aggregation). The input
    cohort and ``comms`` are not modified, so a round stays pure.

    A sharded cohort (`CohortBatch.shard`; no padding rows) is encoded and
    decoded block by block, each rank its own rows with the slots
    ``rows[row0:row0 + b]``; the new error-feedback rows are all-gathered,
    so every rank holds the whole residual.
    """
    if cfg.codec == "identity":
        return cohort, comms
    codec = CODECS[cfg.codec]
    if cohort.mesh is not None:
        return _roundtrip_shard(codec, cohort, ravel(base), comms, rows)
    n = cohort.n
    ef = full_ef = None
    if codec.stateful:
        full_ef = comms["ef"]
        if rows is not None:
            # analysis: allow=retrace-fresh-array -- the round's slot
            # indices; no copy when they come as a device tensor (engine)
            rows = torch.as_tensor(rows, dtype=torch.long,
                                   device=full_ef.device)
        ef = full_ef[:n] if rows is None else full_ef[rows]
    b = _ravel_rows(base) if stacked_base else ravel(base)
    payload, new_ef = codec.encode(cohort.flat[:n], b, ef)
    flat = codec.decode(payload, b)
    if cohort.size > n:
        flat = torch.cat([flat, flat[-1:].expand(cohort.size - n, -1)])
    if codec.stateful:
        if rows is None and n == full_ef.shape[0]:
            full_ef = new_ef
        else:
            full_ef = full_ef.clone()
            full_ef[slice(0, n) if rows is None else rows] = new_ef
        comms = {"ef": full_ef}
    return dataclasses.replace(cohort, flat=flat), comms
