"""PAGANI's shard-local pipeline stages and VEGAS on a mesh (PyTorch port
of ``gpuintegration_tpu/parallel/sharded.py``).

Each rank owns an independent BLOCKED sub-pool of per-shard capacity
``cap_s`` with its own region count.  Evaluation, refinement, compaction
and split never move region data between ranks: each stage here is the
single-device stage on the rank's shard, and the only traffic is the
all-reduce of the f64 iteration scalars (``parallel.mesh``).  On the card
``sharded_eval_stage`` is ``rule_eval.apply_rule``, so each rank takes the
rule kernel's route (tile, generic, split or components) exactly as one
device does.  ``Workspace(mesh=)`` runs these steps inline in its loops;
the stages are the reference's API for a caller that drives its own loop.
"""
from __future__ import annotations

import torch

from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.parallel import mesh as pmesh


def sharded_eval_stage(f, ndim: int, dtype_name: str, mesh, lows, lengths,
                       global_lo, global_range, ns=None, chunk_size=None,
                       blocked: bool = False, ncomp: int = 1,
                       with_split_frac: bool = False):
    """The rule over this rank's shard (reference ``sharded.py:47-110``):
    ``rule_eval.apply_rule`` with ``n = ns``, this shard's count (None: the
    whole padded shard).  Returns (est, err, split_dim[, frac]), est and err
    (ncomp, cap_s) for a vector."""
    pmesh.check_mesh(mesh)
    tables = rule_eval.rule_tables(ndim, dtype_name)
    return rule_eval.apply_rule(
        f, tables, lows, lengths, global_lo, global_range,
        chunk_size=chunk_size, n=ns, blocked=blocked, ncomp=ncomp,
        with_split_frac=with_split_frac)


def sharded_reductions(mesh, est, refined, active):
    """The global [sum est, sum refined, sum active est, sum active
    refined, sum active] (f64) over the shards (``sharded.py:113-125``)."""
    f64 = torch.float64
    s = torch.stack([torch.sum(est).to(f64), torch.sum(refined).to(f64),
                     torch.sum(active * est).to(f64),
                     torch.sum(active * refined).to(f64),
                     torch.sum(active).to(f64)])
    return pmesh.all_reduce_sum(mesh, s)


def _post(math, relerr_classification, blocked, mesh, est, err, n,
          parent_est, use_refine, epsrel, lengths, abs_per_vol):
    est, refined, active, scalars = math(
        relerr_classification, blocked, est, err, n, parent_est, use_refine,
        epsrel, lengths=lengths, abs_per_vol=abs_per_vol)
    n_act = int(scalars[-1])
    mask = region_pool.block_mask(est.shape[-1], n, blocked, est.device)
    return (est, refined, active, mask, n_act,
            pmesh.all_reduce_sum(mesh, scalars))


def sharded_post_stage(relerr_classification, blocked, mesh, est, err, n,
                       parent_est, use_refine, epsrel, lengths=None,
                       abs_per_vol=None):
    """``workspace.iteration_math`` on this rank's shard (``n`` its count),
    then ONE all-reduce of its f64 [iter_est, iter_err, finished_est,
    finished_err, n_active] (``sharded.py:128-170``).  Returns (est,
    refined, active, the shard's validity mask, the shard's n_active, the
    global scalars)."""
    from gpuintegration_torch.pagani.workspace import iteration_math
    return _post(iteration_math, relerr_classification, blocked, mesh, est,
                 err, n, parent_est, use_refine, epsrel, lengths, abs_per_vol)


def sharded_post_stage_vector(relerr_classification, blocked, mesh, est,
                              err, n, parent_est, use_refine, epsrel,
                              lengths=None, abs_per_vol=None):
    """The vector twin (``sharded.py:173-212``): ``iteration_math_vector``
    on component-major (ncomp, cap_s) shards and one all-reduce of the
    (4 ncomp + 1,) f64 vector."""
    from gpuintegration_torch.pagani.workspace import iteration_math_vector
    return _post(iteration_math_vector, relerr_classification, blocked, mesh,
                 est, err, n, parent_est, use_refine, epsrel, lengths,
                 abs_per_vol)


def sharded_compact_split(mesh, out_capacity: int, active, lows, lengths,
                          sdim, est, refined, extra=None):
    """Shard-local compaction of this rank's survivors and their split into
    its own blocked bucket of per-shard capacity ``out_capacity``
    (``sharded.py:215-265``); ``extra``: the cut fractions of a crease
    run, compacted alongside and given to the split.  Returns (the shard's
    children count, child lows, child lengths, parent estimates, parent
    errors); nothing crosses ranks."""
    pmesh.check_mesh(mesh)
    n_act = int((active > 0).sum())
    cres = region_pool.compact(active, lows, lengths, sdim, est, refined,
                               out_capacity=out_capacity // 2, extra=extra)
    lo2, ln2, n2 = region_pool.split(
        cres[0], cres[1], cres[2], n_act, out_capacity=out_capacity,
        frac=cres[5] if extra is not None else None)
    return n2, lo2, ln2, cres[3], cres[4]


def sharded_split(mesh, out_capacity: int, lows, lengths, sdim, n: int,
                  frac=None):
    """Shard-local split of ``n`` already compacted survivors into a doubled
    bucket (the fused phase's overflow exit; ``sharded.py:268-290``).
    Returns (2 n, child lows, child lengths)."""
    pmesh.check_mesh(mesh)
    lo2, ln2, n2 = region_pool.split(lows, lengths, sdim, n,
                                     out_capacity=out_capacity, frac=frac)
    return n2, lo2, ln2


def vegas_sharded(integrand, epsrel=1e-3, epsabs=1e-12, ncall=1e6, vol=None,
                  *, mesh, **kw):
    """Multi-device m-CUBES: ``mcubes.vegas.vegas(..., mesh=mesh)``, the same
    driver as one device's (``sharded.py:293-313``)."""
    from gpuintegration_torch.mcubes.vegas import vegas
    return vegas(integrand, epsrel, epsabs, ncall, vol, mesh=mesh, **kw)
