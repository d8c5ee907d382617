"""Probe planning: query tiling and per-batch probe deduplication — the
port of ``repro.core.probes`` (the RAM tier's part, and the disk tier's
host-side fetch lists: :func:`fetch_order`, :func:`tile_fetch_lists`,
:func:`tile_release_lists`, :func:`split_fetch_by_owner`; and
:func:`bound_order`, the bound-driven executor's best-bound-first slot
permutation).

Queries are grouped into tiles of ``q_block`` rows; per tile, the Q·T probe
ids are sorted and deduplicated into a table of ``u_cap`` unique-cluster
slots (padded by repeating the last unique id); every (query, t) probe keeps
a pointer into the table so its candidates can be gathered back after the
scan.  All shapes are static (sort + cumsum + scatter).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# int32 max: sorts after every real key, so invalid entries sink to the end.
_SENTINEL = 2**31 - 1


def dedup_rows(keys: torch.Tensor, valid: Optional[torch.Tensor], cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise sorted dedup into a static-size unique table.

    Args:
      keys:  [R, L] int32 (each row deduped independently).
      valid: [R, L] bool or None; invalid entries are excluded.
      cap:   static table width.

    Returns:
      table   [R, cap] int32 — unique keys, ascending; tail slots repeat the
              row's last unique key (0 for all-invalid rows).
      slot_of [R, L] int32 — UNCAPPED unique index of each entry's key (junk,
              but >= 0, where ``valid`` is False); values >= cap overflowed.
      count   [R] int32 — number of unique valid keys per row.
    """
    r, l = keys.shape
    dev = keys.device
    k = keys.int() if valid is None else torch.where(valid, keys.int(), _SENTINEL)
    order = torch.argsort(k, dim=1, stable=True)
    ks = torch.gather(k, 1, order)  # [R, L] ascending
    vs = ks != _SENTINEL
    first = vs & torch.cat(
        [torch.ones((r, 1), dtype=torch.bool, device=dev),
         ks[:, 1:] != ks[:, :-1]], dim=1)
    slot_sorted = torch.clamp(torch.cumsum(first.int(), dim=1) - 1, min=0)
    count = first.sum(dim=1).int()

    # the reference's mode="drop" scatter: destinations >= cap land in a
    # spare column that is cut off
    dest = torch.where(first & (slot_sorted < cap), slot_sorted, cap)
    table = torch.zeros((r, cap + 1), dtype=torch.int32, device=dev)
    table.scatter_(1, dest.long(), ks)
    table = table[:, :cap]
    capped = torch.clamp(count, max=cap)
    last = torch.gather(table, 1, torch.clamp(capped - 1, min=0).long()[:, None])
    table = torch.where(
        torch.arange(cap, device=dev)[None, :] < torch.clamp(capped, min=1)[:, None],
        table, last)

    slot_of = torch.zeros((r, l), dtype=torch.int32, device=dev)
    slot_of.scatter_(1, order, slot_sorted.int())
    return table, slot_of, count


def plan_probe_tiles(probe_ids: torch.Tensor, *, q_block: int, u_cap: int,
                     probe_valid: Optional[torch.Tensor] = None):
    """Builds the tiled kernel's slot tables for a single-host batch.

    Args:
      probe_ids: [Qpad, T] int32 cluster ids, Qpad a multiple of q_block.
      q_block:   query-tile height QB.
      u_cap:     unique-probe capacity per tile; probes beyond it are
                 reported via ``probe_ok`` and their candidates dropped.
      probe_valid: optional [Qpad, T] bool — probes the planner pruned never
                 enter the slot tables and report ``probe_ok=False``.

    Returns ``(slot_cluster [n_tiles·u_cap], slot_tile [n_tiles·u_cap],
    slot_of_probe [Qpad, T], probe_ok [Qpad, T], n_unique [n_tiles])``.
    """
    qpad, t = probe_ids.shape
    if qpad % q_block:
        raise ValueError(f"Qpad={qpad} not a multiple of q_block={q_block}")
    n_tiles = qpad // q_block
    dev = probe_ids.device
    flat = probe_ids.reshape(n_tiles, q_block * t).int()
    valid = (None if probe_valid is None
             else probe_valid.reshape(n_tiles, q_block * t))
    table, slot_of, count = dedup_rows(flat, valid, u_cap)
    slot_cluster = table.reshape(-1)
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    slot_tile = torch.repeat_interleave(tiles, u_cap)
    probe_ok = (slot_of < u_cap).reshape(qpad, t)
    if probe_valid is not None:
        probe_ok = probe_ok & probe_valid
    slot_of_probe = (
        torch.clamp(slot_of, max=u_cap - 1) + tiles[:, None] * u_cap
    ).reshape(qpad, t).int()
    return slot_cluster, slot_tile, slot_of_probe, probe_ok, count


def pad_to_tiles(x: torch.Tensor, q_block: int) -> torch.Tensor:
    """Pads the leading (query) axis up to a q_block multiple with copies of
    the last row, which dedupe into the real queries' probe slots."""
    q = x.shape[0]
    pad = (-q) % q_block
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], dim=0)


def _host(x) -> np.ndarray:
    """A slot table as a host numpy array (tensors on any device)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def fetch_order(slot_cluster, n_unique, u_cap: int) -> np.ndarray:
    """The disk tier's cache fetch list from a probe plan (host-side).

    Flattens the per-tile unique-probe tables into one duplicate-free list
    of cluster ids in *first-need order*: tile 0's unique clusters first,
    then tile 1's novel ones, and so on.

    Args:
      slot_cluster: [n_tiles·u_cap] int32 (``plan_probe_tiles`` output).
      n_unique:     [n_tiles] int32 live-slot counts (pads excluded).
      u_cap:        per-tile slot capacity.

    Returns a 1-D int64 numpy array of distinct cluster ids.
    """
    sc = _host(slot_cluster).reshape(-1, u_cap).astype(np.int64)
    nu = _host(n_unique)
    live = np.arange(u_cap)[None, :] < nu[:, None]  # [n_tiles, u_cap]
    flat = sc[live]  # row-major: tile 0's slots first, then tile 1's, ...
    uniq, first = np.unique(flat, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


def _live_flat(slot_cluster, n_unique, u_cap: int):
    """Flattens live slots row-major (tile 0 first) with their tile ids."""
    sc = _host(slot_cluster).reshape(-1, u_cap).astype(np.int64)
    nu = _host(n_unique)
    n_tiles = sc.shape[0]
    live = np.arange(u_cap)[None, :] < nu[:, None]  # [n_tiles, u_cap]
    tile_of = np.broadcast_to(np.arange(n_tiles)[:, None], sc.shape)
    return n_tiles, sc[live], tile_of[live]


def tile_fetch_lists(slot_cluster, n_unique, u_cap: int) -> List[np.ndarray]:
    """Per-tile *novel*-cluster fetch lists (host-side).

    Tile i's list holds the clusters it needs that no earlier tile already
    fetched, in slot order; concatenating every tile's list reproduces
    :func:`fetch_order`.  Returns one 1-D int64 numpy array per tile.
    """
    n_tiles, flat, flat_tile = _live_flat(slot_cluster, n_unique, u_cap)
    uniq, first = np.unique(flat, return_index=True)
    order = np.argsort(first, kind="stable")  # first-need (slot) order
    uniq = uniq[order]
    first_tile = flat_tile[first][order]
    return [uniq[first_tile == t] for t in range(n_tiles)]


def tile_release_lists(slot_cluster, n_unique, u_cap: int
                       ) -> List[np.ndarray]:
    """Per-tile *last-need* cluster lists (host-side).

    Tile i's list holds the clusters no tile after i needs, in slot order:
    the per-batch operand cache frees each record right after its last
    consuming tile.  The lists partition the batch's unique clusters.
    """
    n_tiles, flat, flat_tile = _live_flat(slot_cluster, n_unique, u_cap)
    rev = flat[::-1]
    uniq, first_rev = np.unique(rev, return_index=True)
    last = flat.shape[0] - 1 - first_rev  # last occurrence in need order
    order = np.argsort(last, kind="stable")
    uniq = uniq[order]
    last_tile = flat_tile[last][order]
    return [uniq[last_tile == t] for t in range(n_tiles)]


def bound_order(slot_cluster, n_unique, slot_of_probe, slot_bound,
                u_cap: int):
    """Permutes each tile's live slots best-bound-first (host-side).

    The bound-driven executor scans the slots most likely to hold top-k
    candidates first, so the running kth rises fast and later slots can be
    dropped on a bound.  Each tile's live region ``[0, u)`` is reordered by
    descending ``slot_bound`` (stable), the pad region repeats the *new*
    last live slot, and every probe pointer is remapped through the
    permutation.  Run it before any fetch list is built from the tables.

    Args:
      slot_cluster:  [n_tiles·u_cap] int32 (``plan_probe_tiles`` output).
      n_unique:      [n_tiles] live-slot counts.
      slot_of_probe: [Qpad, T] int32 flat slot pointers.
      slot_bound:    [n_tiles, u_cap] per-slot priority.
      u_cap:         per-tile slot capacity.

    Returns ``(slot_cluster', slot_of_probe', perm)`` as host numpy arrays;
    ``perm [n_tiles, u_cap]`` maps new slot position -> old position
    (identity on pads), for co-permuting per-slot state.
    """
    sc = np.array(_host(slot_cluster).reshape(-1, u_cap), np.int32)
    nu = _host(n_unique)
    bound = _host(slot_bound)
    n_tiles = sc.shape[0]
    perm = np.broadcast_to(np.arange(u_cap, dtype=np.int32),
                           (n_tiles, u_cap)).copy()
    inv = perm.copy()
    for t in range(n_tiles):
        u = min(int(nu[t]), u_cap)
        if u <= 1:
            continue
        order = np.argsort(-bound[t, :u], kind="stable").astype(np.int32)
        perm[t, :u] = order
        sc[t, :u] = sc[t, order]
        sc[t, u:] = sc[t, u - 1]  # pads repeat the new last live slot
        inv_t = np.empty(u, np.int32)
        inv_t[order] = np.arange(u, dtype=np.int32)
        inv[t, :u] = inv_t  # positions >= u keep identity (clipped pads)
    t_idx, s = np.divmod(_host(slot_of_probe).astype(np.int32), u_cap)
    sop = (t_idx * u_cap + inv[t_idx, s]).astype(np.int32)
    return sc.reshape(-1), sop, perm


def split_fetch_by_owner(fetch, owner_of, alive=None):
    """Splits a first-need fetch list per owning node (host-side).

    ``fetch`` is any fetch-list unit (a whole-plan :func:`fetch_order`, or
    one tile's :func:`tile_fetch_lists` entry); ``owner_of`` maps cluster
    ids to node ids (a ``blockstore.HashRing`` / ``RangeOwnership``).  Each
    owner's sublist keeps the input's first-need order, and the sublists
    partition the input.  ``alive`` (parallel bool mask) drops entries
    whose every (query, probe) pair is already dead before the split.

    Returns ``{node_id: 1-D int64 array}`` for the owners that appear.
    """
    fetch = np.asarray(fetch, dtype=np.int64).reshape(-1)
    if alive is not None:
        fetch = fetch[np.asarray(alive, dtype=bool).reshape(-1)]
    if fetch.size == 0:
        return {}
    owners = np.asarray(owner_of(fetch))
    return {int(o): fetch[owners == o] for o in np.unique(owners)}
