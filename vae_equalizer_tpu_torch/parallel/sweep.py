"""Hyperparameter-grid sweep engine (port of ``vae_equalizer_tpu/parallel/sweep.py``).

The reference drives sweeps with up to 10 nested Python for-loops and saves
one .mat at the very end (Eval_run_DP.py:67-114). Here, as in the JAX
package:

  * the grid is an explicit cartesian product of config-field axes;
  * the ``iters`` independent repeats of each grid point run as the runs
    axis of one runner call (one kernel launch per frame for all of them);
  * every grid point appends a JSONL record the moment it finishes
    (crash-safe, resumable via ``skip_done``);
  * points that differ only along the lr / SNR / nu axes can run as one
    call, those values batched into the runs (``batch_*_axis``);
  * the final .mat reproduces the reference's tensor layout (axes x iter x
    frames) for its analysis scripts.

Seeds: grid point i runs from ``point_seed(seed, i)``, a function of the
sweep's seed and the point's index alone, so a resumed sweep gives its
remaining points the seeds an uninterrupted sweep gives them (JAX folds the
point index into its key, ``jax.random.fold_in(key, i)``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import itertools
import json
import pathlib
import time

import numpy as np

from ..train import (
    run_cma_awgn,
    run_cma_dp,
    train_vae_dp,
    train_vae_flex_dp,
    train_vae_le_awgn,
    train_vae_nn_awgn,
)
from ..utils import io
from .seqpar import train_vae_dp_sharded, train_vae_flex_dp_sharded

__all__ = ["RUNNERS", "assemble_mat", "expand_grid", "point_seed", "run_sweep"]

RUNNERS = {
    "VAE-LE-AWGN": train_vae_le_awgn,
    "VAE-NN-AWGN": train_vae_nn_awgn,
    "CMA-AWGN": run_cma_awgn,
    "VAE": train_vae_dp,
    "VAE-SP": train_vae_dp_sharded,  # dp x sp sequence-parallel VAE
    "VAEflex-SP": train_vae_flex_dp_sharded,  # dp x sp VAEflex windows
    "VAEflex": train_vae_flex_dp,
    "CMA": run_cma_dp,
    "CMAbatch": run_cma_dp,
    "CMAflex": run_cma_dp,
}


def point_seed(seed: int, i: int) -> int:
    """The seed of grid point ``i`` of a sweep seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def expand_grid(base_cfg, **axes):
    """Cartesian product of config-field value lists.

    Returns (configs, coords, axes) where coords[i] are the per-axis indices
    of configs[i] in the grid (used to scatter results into the .mat tensor).
    """
    names = list(axes)
    values = [list(axes[n]) for n in names]
    configs, coords = [], []
    for combo in itertools.product(*[range(len(v)) for v in values]):
        override = {n: values[i][combo[i]] for i, n in enumerate(names)}
        configs.append(dataclasses.replace(base_cfg, **override))
        coords.append(combo)
    return configs, coords, dict(zip(names, values))


def run_sweep(runner_name: str, base_cfg, axes: dict, iters: int, seed: int, mesh=None,
              out_dir: str | pathlib.Path = "results", tag: str = "", progress=None,
              skip_done: bool = False, save_params: bool = False, compiled: bool = False,
              runner_kwargs: dict | None = None, checkpoint_every: int = 0,
              batch_lr_axis: bool = False, batch_snr_axis: bool = False,
              batch_nu_axis: bool = False, device="cuda"):
    """Run a full grid; returns (records, axes values, JSONL path).

    Each record: {"coords", "config", "runner_kwargs", "wall_s", "ser", ...}
    with ``ser`` of shape (iters, ...), the runner's history with a leading
    repeat axis. Runners are called as ``runner(cfg, seed, device=device,
    runs=iters, mesh=mesh, progress=progress, **runner_kwargs)``: ``mesh``
    (``parallel/mesh.py``) is the runs mesh (``run_mesh``) over whose ranks
    the unsharded runners split each point's runs (``train/batching.py``),
    as JAX's sweep shards them, or the dp x sp mesh (``make_mesh_2d``) of
    the ``VAE-SP`` / ``VAEflex-SP`` runners (``parallel/seqpar.py``).

    Resume: with ``skip_done`` the newest existing ``sweep_{tag}_*.jsonl`` is
    reused and its finished grid points are skipped. A record only counts as
    done if its stored config and runner kwargs match the current grid
    point's, so a resumed sweep with changed axes, values or runner mode
    re-runs (never silently reuses) mismatching points. ``checkpoint_every``
    = K > 0 gives each point of a runner that takes ``checkpoint`` its
    state file ``state_{tag}_{coord}_{hash}.npz`` in ``out_dir``, saved every
    K frames or epochs: a killed sweep resumed with ``skip_done`` also
    resumes its interrupted point in the middle. The hash is of (config,
    iters), and of the runner kwargs too where there are any, so a file is
    only ever resumed by the same point of the same experiment in the same
    runner mode; a fresh sweep deletes a stale file, and a finished point
    removes its own. ``save_params`` writes each point's trained parameters
    to an .npz.

    ``batch_lr_axis`` / ``batch_snr_axis`` / ``batch_nu_axis``: grid points
    that differ ONLY along the ``lr`` / ``snr_db`` / ``nu`` axes run as ONE
    runner call with those values batched into the runs axis (``lr_vec`` /
    ``snr_vec`` / ``nu_vec``; one kernel B launch per frame for the whole
    group). Each point still gets its own JSONL record, with its own
    demapper variance (the runner's ``var_runs``); the call takes the seed of
    the group's FIRST point, so its results are statistically, not bitwise,
    those of the unbatched sweep. Groups with partly finished resume records
    run point by point; incompatible with ``checkpoint_every``.
    """
    runner = RUNNERS[runner_name]
    runner_params = inspect.signature(runner).parameters
    has_kw = lambda kw: kw in runner_params or any(  # noqa: E731
        p.kind is inspect.Parameter.VAR_KEYWORD for p in runner_params.values())
    configs, coords, axes_values = expand_grid(base_cfg, **axes)
    out_dir = pathlib.Path(out_dir)
    stamp = time.strftime("%y%m%d%H%M%S")
    tag = tag or runner_name
    jsonl = out_dir / f"sweep_{tag}_{stamp}.jsonl"
    rk_now = io._to_jsonable(runner_kwargs or {})

    def cfg_json(cfg):
        return io._to_jsonable(dataclasses.asdict(cfg))

    done = {}
    results = []
    if skip_done:
        prior = sorted(out_dir.glob(f"sweep_{tag}_*.jsonl"))
        if prior:
            jsonl = prior[-1]
            expected = {tuple(c): cfg_json(cf) for c, cf in zip(coords, configs)}
            for r in io.read_jsonl(jsonl):
                c = tuple(r["coords"])
                if expected.get(c) == r.get("config") and r.get("runner_kwargs", {}) == rk_now:
                    done[c] = r
                    results.append(r)  # finished points feed the .mat
                else:
                    print(f"# resume: record at {c} has a different config or runner mode; "
                          "re-running", flush=True)

    def write_record(cfg, coord, res_point, wall):
        record = {
            "coords": list(coord),
            "config": dataclasses.asdict(cfg),
            "runner_kwargs": rk_now,
            "wall_s": wall,
            **{m: res_point[m] for m in ("ser", "mi", "var_est", "var") if m in res_point},
        }
        io.append_jsonl(jsonl, record)
        if save_params:
            state = res_point.get("params", res_point.get("taps"))
            if state is not None:
                if not isinstance(state, dict):
                    state = {"taps": state}
                ckpt = out_dir / f"ckpt_{tag}_{stamp}_{'_'.join(map(str, coord))}.npz"
                io.save_checkpoint(ckpt, state)
                record["checkpoint"] = str(ckpt)
        results.append(record)

    def call(cfg, i, **kwargs):
        kwargs = dict(device=device, mesh=mesh, progress=progress, **kwargs, **(runner_kwargs or {}))
        if compiled and "compiled" in runner_params:
            kwargs["compiled"] = True
            kwargs.pop("progress")
        t0 = time.time()
        return runner(cfg, point_seed(seed, i), **kwargs), time.time() - t0

    batch_fields = []  # (axis index in coords, cfg field, runner kwarg)
    point_groups: dict = {}
    want = ([("lr", "lr_vec")] if batch_lr_axis else []) + (
        [("snr_db", "snr_vec")] if batch_snr_axis else []) + (
        [("nu", "nu_vec")] if batch_nu_axis else [])
    if want:
        if checkpoint_every:
            raise ValueError("batch_lr_axis/batch_snr_axis are incompatible with checkpoint_every")
        names = list(axes)
        for field, kw in want:
            if field in names and len(axes_values[field]) > 1:
                if not has_kw(kw):
                    raise ValueError(f"runner {runner_name!r} has no {kw} support")
                batch_fields.append((names.index(field), field, kw))
        if batch_fields:
            drop = {ax for ax, _, _ in batch_fields}
            gkey = lambda c: tuple(v for a, v in enumerate(c) if a not in drop)
            for j, c in enumerate(coords):
                point_groups.setdefault(gkey(c), []).append(j)

    handled: set = set()
    for i, (cfg, coord) in enumerate(zip(configs, coords)):
        if tuple(coord) in done or tuple(coord) in handled:
            continue
        if batch_fields:
            idxs = point_groups[gkey(tuple(coord))]
            if len(idxs) > 1 and not any(tuple(coords[j]) in done for j in idxs):
                n_pt = len(idxs)
                vec_kw = {kw: np.repeat(np.asarray([getattr(configs[j], field) for j in idxs],
                                                   np.float32), iters)
                          for _, field, kw in batch_fields}
                res, wall = call(cfg, i, runs=iters * n_pt, **vec_kw)
                for bj, j in enumerate(idxs):
                    blk = slice(bj * iters, (bj + 1) * iters)
                    res_j = {m: np.asarray(res[m])[blk] for m in ("ser", "mi", "var_est") if m in res}
                    if "var_runs" in res:  # per-run var (snr- / nu-axis batching)
                        res_j["var"] = np.asarray(res["var_runs"])[bj * iters]
                    elif "var" in res:  # per-point constant
                        res_j["var"] = res["var"]
                    state = res.get("params", res.get("taps"))
                    if state is not None:
                        res_j["params"] = ({k: v[blk] for k, v in state.items()}
                                           if isinstance(state, dict) else state[blk])
                    write_record(configs[j], coords[j], res_j, wall / n_pt)
                    handled.add(tuple(coords[j]))
                continue
        kwargs, state_file = {}, None
        if checkpoint_every and has_kw("checkpoint"):
            # the point's identity names its state file: runner_kwargs count
            # (use_pallas changes the carry), and without them the hash is of
            # (cfg, iters) alone, as the JAX package names its files
            ident = (cfg_json(cfg), iters) if not runner_kwargs else (
                cfg_json(cfg), iters, runner_kwargs)
            h = hashlib.sha1(json.dumps(ident, sort_keys=True, default=str).encode())
            state_file = out_dir / f"state_{tag}_{'_'.join(map(str, coord))}_{h.hexdigest()[:10]}.npz"
            if not skip_done and state_file.exists():
                state_file.unlink()  # a fresh sweep never resumes stale state
            kwargs = dict(checkpoint=state_file, checkpoint_every=checkpoint_every)
        res, wall = call(cfg, i, runs=iters, **kwargs)
        write_record(cfg, coord, res, wall)
        if state_file is not None and state_file.exists():
            state_file.unlink()  # the point finished: drop its resume state
    return results, axes_values, jsonl


def assemble_mat(results, axes_values, iters: int, lead_shape: tuple[int, ...], key: str = "ser"):
    """Scatter per-point metric histories into the reference's tensor layout.

    lead_shape: leading dims of one run's history (e.g. (4,) rows for DP SER,
    (2,) for Var_est, () for AWGN). Returns ndarray of shape
    lead_shape + grid_dims + (iters, history_len). A per-point constant (a
    record value with no iters/history axes, e.g. the true noise variance
    ``var`` -> the reference's ``var_real`` with history length 1,
    Eval_run_DP.py:54) is broadcast over the iters axis. Returns None when no
    record carries ``key``.
    """
    grid_dims = tuple(len(v) for v in axes_values.values())
    first = next((np.asarray(r[key]) for r in results if key in r), None)
    if first is None:
        return None
    per_point_const = first.ndim == len(lead_shape)
    hist_len = 1 if per_point_const else first.shape[-1]
    out = np.full(lead_shape + grid_dims + (iters, hist_len), np.nan, np.float32)
    for rec in results:
        if key not in rec:
            continue
        arr = np.asarray(rec[key])  # (iters, *lead_shape, hist)
        if per_point_const:
            arr = arr.reshape(lead_shape + (1, 1))  # broadcasts over iters
        else:
            arr = np.moveaxis(arr, 0, -2) if arr.ndim > 2 else arr  # lead axes first
        idx = (slice(None),) * len(lead_shape) + tuple(rec["coords"])
        out[idx] = arr
    return out
