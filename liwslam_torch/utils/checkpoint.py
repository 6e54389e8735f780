"""Checkpoint / resume: snapshot the SLAM state to disk.

Port of ``liwslam/utils/checkpoint.py``, with the same file layout and
keys, so each package loads the other's files:

- a state of NamedTuples (nested, of tensors): its leaves depth-first in
  field order, one ``.npz`` with ``leaf_<i>`` arrays, restored against a
  template of the same structure (JAX flattens a NamedTuple pytree in the
  same order);
- KeyframeManager: keyframes, edges and descriptor maps in ``<prefix>.npz``
  plus a JSON header in ``<prefix>.json``.  Descriptor bitmaps are written
  as uint32, as the reference writes them.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _leaves(tree):
    """Leaves depth-first in field order (dict keys sorted; None holds no
    leaf), as JAX flattens a pytree."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def _rebuild(template, it):
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        a = next(it)
        return torch.as_tensor(np.asarray(a)).to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if hasattr(template, "_fields"):
        return type(template)(*[_rebuild(t, it) for t in template])
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(t, it) for t in template)
    return type(template)(np.asarray(next(it)).item())


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path, tree):
    np.savez_compressed(path, **{f"leaf_{i}": _host(l) for i, l in enumerate(_leaves(tree))})


def load_pytree(path, template):
    """The saved leaves in ``template``'s structure, each with the dtype and
    device of the template's leaf."""
    z = np.load(path)
    n = len(_leaves(template))
    return _rebuild(template, iter(z[f"leaf_{i}"] for i in range(n)))


def save_manager(prefix, mgr):
    """KeyframeManager -> <prefix>.json + <prefix>.npz."""
    head = {
        "n_keyframes": len(mgr.keyframes),
        "modify_delta": {str(s): np.asarray(T).tolist() for s, T in mgr._modify_delta.items()},
        "kf_session": [kf.session for kf in mgr.keyframes],
        "last_solve_t_us": mgr.last_solve_t_us,
        "has_loop_pending": mgr.has_loop_pending,
        "seq_edges": [(i, j) for i, j, _ in mgr.seq_edges],
        "loop_edges": [(i, j) for i, j, _ in mgr.loop_edges],
        "kf_t_us": [kf.t_us for kf in mgr.keyframes],
        "kf_is_laser": [kf.is_laser for kf in mgr.keyframes],
        "mf_present": [f is not None for f in mgr.map_features],
        "mf_index": [int(m["index"]) if m is not None else -1 for m in mgr.mf_meta],
        "session_root": {str(s): int(r) for s, r in mgr._session_root.items()},
    }
    arrays = {}
    for k, kf in enumerate(mgr.keyframes):
        arrays[f"kf{k}_T"] = kf.T_tracking
        arrays[f"kf{k}_p"] = kf.p
        arrays[f"kf{k}_q"] = kf.q
        arrays[f"kf{k}_corners"] = kf.corners
        arrays[f"kf{k}_l1"] = np.asarray(kf.scan_lines[0])
        arrays[f"kf{k}_l2"] = np.asarray(kf.scan_lines[1])
    for n, (i, j, tf) in enumerate(mgr.seq_edges):
        arrays[f"se{n}"] = np.asarray(tf)
    for n, (i, j, tf) in enumerate(mgr.loop_edges):
        arrays[f"le{n}"] = np.asarray(tf)
    # each pool field copied to the host once, sliced per slot there
    pool = {f: _host(x) for f, x in mgr._mf_pool.items()} if mgr._mf_pool is not None else None
    for k, slot in enumerate(mgr.map_features):
        if slot is None:
            continue
        for field in mgr._POOL_FIELDS:
            a = pool[field][slot]
            arrays[f"mf{k}_{field}"] = a.view(np.uint32) if field == "bitmap" else a
    with open(prefix + ".json", "w") as fh:
        json.dump(head, fh)
    np.savez_compressed(prefix + ".npz", **arrays)


def load_manager(prefix, params, device="cuda"):
    """A KeyframeManager on ``device`` from <prefix>.json + <prefix>.npz,
    written by this package's :func:`save_manager` or the reference's."""
    from liwslam_torch.backend.loop import MapFeature
    from liwslam_torch.backend.manager import Keyframe, KeyframeManager

    with open(prefix + ".json") as fh:
        head = json.load(fh)
    z = np.load(prefix + ".npz")
    mgr = KeyframeManager(params, device=device)
    mgr._modify_delta = {int(s): np.asarray(T) for s, T in head["modify_delta"].items()}
    mgr.last_solve_t_us = head["last_solve_t_us"]
    mgr.has_loop_pending = head["has_loop_pending"]
    mgr._session_root = {int(s): int(r) for s, r in head.get("session_root", {}).items()}
    for k in range(head["n_keyframes"]):
        mgr.keyframes.append(
            Keyframe(
                t_us=head["kf_t_us"][k],
                T_tracking=z[f"kf{k}_T"],
                p=z[f"kf{k}_p"],
                q=z[f"kf{k}_q"],
                is_laser=head["kf_is_laser"][k],
                corners=z[f"kf{k}_corners"],
                scan_lines=(z[f"kf{k}_l1"], z[f"kf{k}_l2"]),
                session=head["kf_session"][k],
            )
        )
    # the per-session rolling corner window the descriptor builder reads
    # (the last submap_count laser keyframes per session, in order)
    for k, kf in enumerate(mgr.keyframes):
        if not kf.is_laser:
            continue
        hist = mgr._corner_hist.setdefault(kf.session, [])
        hist.append((k, np.asarray(kf.corners).reshape(-1, 3)))
        if len(hist) > params.submap_count:
            del hist[: len(hist) - params.submap_count]
    mgr.seq_edges = [(i, j, z[f"se{n}"]) for n, (i, j) in enumerate(head["seq_edges"])]
    mgr.loop_edges = [(i, j, z[f"le{n}"]) for n, (i, j) in enumerate(head["loop_edges"])]
    for k, present in enumerate(head["mf_present"]):
        if not present:
            mgr.map_features.append(None)
            mgr.mf_meta.append(None)
            continue
        arr = {f: z[f"mf{k}_{f}"] for f in mgr._POOL_FIELDS}
        arr["bitmap"] = arr["bitmap"].view(np.int32)
        mf = MapFeature(*[torch.as_tensor(np.ascontiguousarray(arr[f])) for f in mgr._POOL_FIELDS], index=head["mf_index"][k])
        slot = mgr._pool_add(mf)
        mgr.map_features.append(slot)
        mgr.mf_meta.append(
            dict(
                n_valid=int(arr["valid"].sum()),
                origin=np.asarray(arr["origin"], np.float64),
                index=head["mf_index"][k],
                slot=slot,
            )
        )
    return mgr
