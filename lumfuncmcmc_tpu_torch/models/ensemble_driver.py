"""Ensemble-sampler fit drivers (port of
``lumfuncmcmc_tpu/models/ensemble_driver.py``): ``fit_model`` with chain
checkpoints and resume, ``fit_model_until`` (stop at a min-ESS target)
and ``fit_model_ensembles`` (independent replicated ensembles, the true
cross-ensemble R-hat), meshless or on the host's grid of ranks
(``self.grid``): there every rank runs the driver on the grid's lnprob
(``lnprob_batch``) and holds the whole chain, the ensembles go whole to
the ranks (``run_stretch_ensembles_sharded``), rank 0 alone writes the
checkpoints, and a resume is decided by every rank together: a rank that
reads another checkpoint than the others (a disk that is not shared)
makes every rank raise.

The checkpoint protocol is the port's own; it gives the JAX package's
guarantees. JAX replays a ``jax.random`` key stream on resume; here
block ``b`` of a blocked run draws from a generator seeded off
``(cfg.seed, tag, b)`` (:func:`stream_generator`), so a resume needs
only the block count the npz implies, and a run resumed from a
checkpoint cut at any block boundary reproduces the uninterrupted
checkpointed run exactly (chain, lnprobability, acceptance, and for
``fit_model_until`` its stopping decisions) on one device type. The npz
fingerprint pins every knob the JAX fingerprint pins plus the port's
protocol tag and the device type (CPU and CUDA generators draw different
streams), and on a source-split grid the source ranks (the shards' sums
round apart from the whole catalog's, as JAX pins ``mesh_sources`` for
its stream route): a mismatch, an npz of the JAX package's included,
raises and names the fields. A walker-split grid draws the meshless
chain, so its checkpoints resume on one rank and back. The npz keeps
each block's acceptance counts (``acc_blocks``) beside the chain, so
cutting both on their block axis gives the checkpoint that block
boundary wrote.

The host class provides ``cfg``/``log``/``layout``/``device``/``dtype``,
``grid``, ``lnprob_batch``, ``_meshless_batch``, ``_require_active``,
``_initial_positions`` and ``_log_convergence``.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.samplers.affine import (
    de_schedule, run_stretch, run_stretch_ensembles)
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    burnin_steps, effective_sample_size, gelman_rubin,
    gelman_rubin_ensembles, rank_normalized_rhat_ensembles)
from lumfuncmcmc_tpu_torch.utils.tracing import span

# the port's checkpoint protocol ("lfpt"), the first field of every
# fingerprint: no JAX-written npz carries it
PROTOCOL = 0x6C667074
_MOVE_IDS = {"stretch": 0, "de": 1, "mix": 2}
_DEVICE_IDS = {"cpu": 0, "cuda": 1}
# stream tags of the blocked runs' per-block generators: a min-ess run
# draws block b as the checkpointed run of its block length does (JAX's
# two drivers split the same key stream too), so their chains agree
# block for block
FIT_TAG, ENS_TAG = 0x636b70, 0x656e73


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_generator(seed: int, tag: int, device, *index) -> torch.Generator:
    """A generator on ``device`` seeded off ``seed``'s stream by ``tag``
    and ``index`` (a block number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        (int(seed), int(tag), *map(int, index))).generate_state(
            1, np.uint64)[0]))
    return gen


def npz_path(path):
    """``np.savez`` appends .npz to a bare path; a resume that looked for
    the bare name would silently restart from 0."""
    return path if path is None or path.endswith(".npz") else path + ".npz"


def fingerprint(device, fields):
    """``(values, names)`` of a checkpoint fingerprint: the protocol tag
    and the device type, then ``fields`` ((name, value) pairs)."""
    fields = [("protocol", PROTOCOL),
              ("device", _DEVICE_IDS[torch.device(device).type])] + list(
                  fields)
    return (np.asarray([v for _, v in fields], dtype=np.float64),
            tuple(n for n, _ in fields))


def load_checkpoint(path, want, names, label):
    """The npz at ``path`` as a dict of arrays, after its fingerprint is
    held to ``want``; raises naming the fields on any mismatch."""
    with np.load(path) as ck:
        data = {k: ck[k] for k in ck.files}
    saved = np.asarray(data.get("fingerprint", np.zeros(0)),
                       dtype=np.float64)
    if saved.shape == want.shape and np.array_equal(saved, want):
        return data
    if saved.shape != want.shape or saved[0] != PROTOCOL:
        why = (f"it was not written by this port's {label} protocol (an "
               "npz of the JAX package, or of another run kind: saved "
               f"fingerprint {tuple(saved)}; this run's fields "
               f"({', '.join(names)}) = {tuple(want)})")
    else:
        diff = [f"{n}: saved {s:g}, current {w:g}"
                for n, s, w in zip(names, saved, want) if s != w]
        why = ("resuming with changed settings would corrupt the chain "
               "and its random streams (" + "; ".join(diff) + "; device "
               f"ids {_DEVICE_IDS}, move ids {_MOVE_IDS})")
    raise ValueError(f"{label} checkpoint {path} does not match this run: "
                     f"{why}; delete it or restore the original settings")


def _host(x):
    return x.double().cpu().numpy()


def _save(path, **arrays):
    """``np.savez`` on rank 0 alone (every rank holds the same arrays)."""
    from lumfuncmcmc_tpu_torch.parallel.distributed import is_primary
    if is_primary():
        np.savez(path, **arrays)


def _digest(ck, key="chain") -> float:
    """48 bits of a checkpoint's chain (its array ``key``), exact in a
    float64."""
    if ck is None:
        return -1.0
    return float(int(hashlib.sha1(np.ascontiguousarray(
        ck[key]).tobytes()).hexdigest()[:12], 16))


class _EnsembleDriverMixin:
    """Stretch-ensemble fit drivers and their checkpoint protocol."""

    def _resume_from(self, path, resume, want, names, label):
        """The checkpoint dict at ``path`` to resume from, or None for a
        fresh run; :func:`load_checkpoint`'s refusal raises. On a grid
        every rank decides together: whether the file is there, whether
        it passed, its block count and a digest of its chain must agree on
        every rank, or every rank raises."""
        have = bool(resume and path and os.path.exists(path))
        ck, err = None, None
        if have:
            try:
                ck = load_checkpoint(path, want, names, label)
            except ValueError as e:
                err = e
        if self.grid is not None:
            from lumfuncmcmc_tpu_torch.parallel.distributed import agree
            agree([have, err is None,
                   -1 if ck is None else len(ck["acc_blocks"]), _digest(ck)],
                  f"the {label} to resume from ({path})", self.grid.group)
        if err is not None:
            raise err
        return ck

    @staticmethod
    def _grid_fields(lnprob):
        """The fingerprint's grid field: the source ranks of a lnprob that
        splits the sources (its chain depends on them), else none."""
        n = getattr(lnprob, "source_shards", 1)
        return [("mesh_sources", n)] if n > 1 else []

    def _log_grid(self):
        if self.grid is not None:
            self._require_active()
            self.log.info("Device grid: %s" % (self.grid.shape,))

    def _ens_fingerprint(self, fields):
        cfg = self.cfg
        return fingerprint(self.device, list(fields) + [
            ("seed", cfg.seed), ("move", _MOVE_IDS.get(cfg.move, -1)),
            ("de_prob*1e4", int(round(1e4 * cfg.de_prob)))])

    def _sel(self, nsteps, offset):
        """The global mix schedule's slice for steps ``[offset, offset +
        nsteps)``; None for the other moves."""
        cfg = self.cfg
        return (de_schedule(nsteps, cfg.de_prob, offset=offset)
                if cfg.move == "mix" else None)

    def _run_checkpointed(self, runner, start, nsteps_exec, thin, every,
                          checkpoint_path, resume, label, tag,
                          fields=(), step_axis=0):
        """Block loop and checkpoint/resume of :meth:`fit_model`
        (``step_axis=0``) and :meth:`fit_model_ensembles` (``step_axis=1``,
        ``fields`` adding ``nensembles``).

        ``runner(pos, generator, nblk, sel) -> (state, chain, lnp, acc)``
        runs one block; ``start()`` gives the walkers of a fresh run.
        ``nsteps`` is not fingerprinted: a finished run can be extended.
        Returns ``(chain, lnps, acc)`` as host float64 arrays
        concatenated on ``step_axis``.
        """
        checkpoint_path = npz_path(checkpoint_path)
        if every % thin:
            every = max(thin, every - (every % thin))
            self.log.warning("checkpoint_every rounded down to %d (a "
                             "multiple of thin=%d)" % (every, thin))
        want, names = self._ens_fingerprint(
            [("nwalkers", self.cfg.nwalkers), ("thin", thin),
             ("every", every)] + list(fields))
        parts_c, parts_l, accs = [], [], []
        done = 0
        ck = self._resume_from(checkpoint_path, resume, want, names, label)
        if ck is not None:
            parts_c, parts_l = [ck["chain"]], [ck["lnprobability"]]
            accs = list(ck["acc_blocks"])
            done = ck["chain"].shape[step_axis] * thin
            last = np.take(ck["chain"], -1, axis=step_axis)
            pos = torch.as_tensor(last, dtype=self.dtype,
                                  device=self.device)
            self.log.info("Resumed from checkpoint at step %d" % done)
        else:
            pos = start()
        block = len(accs)
        while done < nsteps_exec:
            nblk = min(every, nsteps_exec - done)
            gen = stream_generator(self.cfg.seed, tag, self.device, block)
            state, ch, lp, ac = runner(pos, gen, nblk, self._sel(nblk, done))
            pos = state.pos
            parts_c.append(_host(ch))
            parts_l.append(_host(lp))
            accs.append(_host(ac))
            done += nblk
            block += 1
            if checkpoint_path:
                _save(checkpoint_path,
                      chain=np.concatenate(parts_c, axis=step_axis),
                      lnprobability=np.concatenate(parts_l, axis=step_axis),
                      acc_blocks=np.stack(accs), fingerprint=want)
        return (np.concatenate(parts_c, axis=step_axis),
                np.concatenate(parts_l, axis=step_axis),
                np.sum(np.stack(accs), axis=0))

    def _steps_exec(self):
        cfg = self.cfg
        thin = max(cfg.thin, 1)
        if thin > cfg.nsteps:
            raise ValueError(
                f"thin={thin} exceeds nsteps={cfg.nsteps}: no step would "
                "ever be recorded")
        nsteps_exec = cfg.nsteps - (cfg.nsteps % thin)
        if nsteps_exec != cfg.nsteps:
            self.log.warning(
                "nsteps=%d is not a multiple of thin=%d; running %d steps"
                % (cfg.nsteps, thin, nsteps_exec))
        return thin, nsteps_exec

    def _default_generator(self, generator):
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.cfg.seed)
        return generator

    def fit_model(self, generator=None, checkpoint_path: Optional[str] = None,
                  resume: bool = False):
        """Run the ensemble sampler; the reference's ``fit_model``
        logging and burn-in rule. ``generator`` (default: seeded with
        ``cfg.seed`` on the run's device) supplies the walker starts
        and, in an unblocked run, every sampler draw.

        With ``0 < cfg.checkpoint_every < nsteps`` the run goes in blocks
        of that many steps, each drawing from its own generator (the
        module's protocol); with ``checkpoint_path`` the accumulated
        chain is saved after each block, and ``resume=True`` continues
        from that file.
        """
        cfg = self.cfg
        generator = self._default_generator(generator)
        self._log_grid()
        lnprob = self.lnprob_batch()
        ndim = self.layout.ndim
        self.log.info(
            "Fitting Schechter model to true luminosity function using the "
            "PyTorch affine-invariant ensemble sampler (engine: %s, "
            "device: %s)" % (getattr(lnprob, "engine", "eager"),
                             self.device))
        thin, nsteps_exec = self._steps_exec()
        every = cfg.checkpoint_every or 0

        def runner(p, gen, n, sel):
            return run_stretch(lnprob, p, gen, n, thin=thin, move=cfg.move,
                               de_prob=cfg.de_prob, de_sel=sel)

        blocked = 0 < every < nsteps_exec
        # a resume takes its walkers from the checkpoint
        pos0 = None if blocked else self._initial_positions(generator)
        _sync(self.device)
        start = time.perf_counter()
        if blocked:
            chain, lnps, acc = self._run_checkpointed(
                runner, lambda: self._initial_positions(generator),
                nsteps_exec, thin, every, checkpoint_path, resume,
                "checkpoint", FIT_TAG, fields=self._grid_fields(lnprob))
        else:
            _, chain, lnps, acc = runner(pos0, generator, nsteps_exec, None)
        with span("post"):
            if not blocked:
                chain, lnps, acc = _host(chain), _host(lnps), _host(acc)
            _sync(self.device)
            elapsed = time.perf_counter() - start
            self.log.info("Total time taken: %0.4f s" % elapsed)
            self.log.info("Time taken per step per walker: %0.4f ms" %
                          (elapsed / nsteps_exec * 1000.0 / cfg.nwalkers))
            self.log.info("lnprob evaluations/s: %0.1f"
                          % (cfg.nwalkers * nsteps_exec / elapsed))

            # with thinning, tau is measured in recorded-step units
            burn, tau = burnin_steps(chain, chain.shape[0])
            self.acceptance_fraction = float(np.mean(acc) / nsteps_exec)
            self.log.info("Mean acceptance fraction: %0.4f" %
                          self.acceptance_fraction)
            self.log.info("AutoCorrelation Steps: %i, Number of Burn-in "
                          "Steps: %i" % (round(tau), burn))
            ess = effective_sample_size(chain[burn:])
            rhat = gelman_rubin(chain[burn:])
            self._log_convergence(chain[burn:])
            self.log.info("min ESS: %.0f; max R-hat: %.4f; ESS/sec: %.0f"
                          % (ess.min(), rhat.max(), ess.min() / elapsed))
            return self._set_samples(chain, lnps, burn, ndim)

    def _set_samples(self, chain, lnps, burn, ndim):
        """(nsteps, W, D) chain -> flat post-burn samples with LnProb as
        the last column, like the reference."""
        self.chain = chain
        full = np.concatenate([chain, lnps[:, :, None]], axis=2)
        self.samples = full[burn:].reshape(-1, ndim + 1)
        self.log.info("Shape of self.samples")
        self.log.info(str(self.samples.shape))
        self.log.info("Median lnprob: %.5f; Max lnprob: %.5f"
                      % (np.median(lnps), np.max(lnps)))
        return self.samples

    @staticmethod
    def _min_ess(chain):
        """``(post-burn min ESS, burn, tau)`` of a (nsteps, W, D) chain
        (0 with fewer than 8 post-burn steps)."""
        burn, tau = burnin_steps(chain, chain.shape[0])
        post = chain[burn:]
        ess = (float(effective_sample_size(post).min())
               if post.shape[0] >= 8 else 0.0)
        return ess, burn, tau

    def fit_model_until(self, min_ess: float, block_steps: int = None,
                        max_blocks: int = 50, generator=None,
                        checkpoint_path: Optional[str] = None,
                        resume: bool = False):
        """Run ``block_steps``-step blocks (default ``cfg.nsteps``; no
        thinning) until every parameter's post-burn-in ESS reaches
        ``min_ess`` or ``max_blocks`` blocks ran, at least one. Block
        ``b`` draws from its own generator (the module's protocol), so
        with ``checkpoint_path`` (saved after every block) a resumed run
        reproduces the uninterrupted chain and its stopping decisions.
        ``generator`` (default seeded with ``cfg.seed``) gives the
        starts. Produces :meth:`fit_model`'s ``samples`` layout."""
        cfg = self.cfg
        block_steps = int(block_steps or cfg.nsteps)
        checkpoint_path = npz_path(checkpoint_path)
        self._log_grid()
        lnprob = self.lnprob_batch()
        ndim = self.layout.ndim
        want, names = self._ens_fingerprint(
            [("nwalkers", cfg.nwalkers), ("block_steps", block_steps)]
            + self._grid_fields(lnprob))
        chains, lnps_parts, accs = [], [], []
        ess_min, burn, tau, nblocks = 0.0, 0, 0.0, 0
        _sync(self.device)
        start = time.perf_counter()
        ck = self._resume_from(checkpoint_path, resume, want, names,
                               "min-ess")
        if ck is not None:
            chains, lnps_parts = [ck["chain"]], [ck["lnprobability"]]
            accs = list(ck["acc_blocks"])
            pos = torch.as_tensor(ck["chain"][-1], dtype=self.dtype,
                                  device=self.device)
            nblocks = len(accs)
            ess_min, burn, tau = self._min_ess(ck["chain"])
            self.log.info("Resumed min-ess checkpoint: %d blocks (%d "
                          "steps), min ESS=%.0f"
                          % (nblocks, ck["chain"].shape[0], ess_min))
        else:
            pos = self._initial_positions(self._default_generator(generator))
        while not chains or (ess_min < min_ess and nblocks < max_blocks):
            gen = stream_generator(cfg.seed, FIT_TAG, self.device, nblocks)
            state, ch, lp, ac = run_stretch(
                lnprob, pos, gen, block_steps, move=cfg.move,
                de_prob=cfg.de_prob,
                de_sel=self._sel(block_steps, nblocks * block_steps))
            nblocks += 1
            pos = state.pos
            chains.append(_host(ch))
            lnps_parts.append(_host(lp))
            accs.append(_host(ac))
            chain = np.concatenate(chains)
            if checkpoint_path:
                _save(checkpoint_path, chain=chain,
                      lnprobability=np.concatenate(lnps_parts),
                      acc_blocks=np.stack(accs), fingerprint=want)
            ess_min, burn, tau = self._min_ess(chain)
            self.log.info("Block %d: %d total steps, tau=%.1f, "
                          "min ESS=%.0f (target %.0f)"
                          % (nblocks, chain.shape[0], tau, ess_min,
                             min_ess))
        _sync(self.device)
        elapsed = time.perf_counter() - start
        chain = np.concatenate(chains)
        self.acceptance_fraction = float(
            np.mean(np.sum(np.stack(accs), axis=0)) / chain.shape[0])
        self.log.info("Total time taken: %0.4f s (%d steps, ESS/sec "
                      "%.0f)" % (elapsed, chain.shape[0],
                                 ess_min / max(elapsed, 1e-9)))
        self.log.info("Mean acceptance fraction: %0.4f"
                      % self.acceptance_fraction)
        self.log.info("min ESS: %.0f (target %.0f, %d blocks)"
                      % (ess_min, min_ess, nblocks))
        if chain.shape[0] - burn >= 4:
            self._log_convergence(chain[burn:])
        return self._set_samples(chain, np.concatenate(lnps_parts), burn,
                                 ndim)

    def fit_model_ensembles(self, nensembles: int, generator=None,
                            checkpoint_path: Optional[str] = None,
                            resume: bool = False, min_ess=None,
                            max_blocks: int = 50):
        """Run ``nensembles`` independent ensembles at once
        (:func:`~lumfuncmcmc_tpu_torch.samplers.affine.run_stretch_ensembles`:
        one lnprob call a half-step over all of them) and report the
        true multi-chain R-hat across them (walkers of one ensemble
        interact, so a single ensemble's split-R-hat understates the
        disagreement of independent runs). The ``samples`` pool the
        post-burn samples of every ensemble.

        ``checkpoint_every``/``checkpoint_path``/``resume`` work as in
        :meth:`fit_model`, the npz with a leading ensemble axis and
        ``nensembles`` fingerprinted. ``min_ess``: ``cfg.nsteps``-step
        blocks until the pooled post-burn min ESS reaches the target or
        ``max_blocks`` blocks ran, saved after every block with
        ``checkpoint_path`` (the :meth:`fit_model_until` protocol).

        On a grid the ensembles go whole to the ranks, each rank running
        its own with the meshless engine (no collective in the loop),
        ``nensembles`` rounded up to a multiple of the ranks.
        """
        cfg = self.cfg
        if nensembles < 2:
            raise ValueError("fit_model_ensembles needs >= 2 ensembles "
                             "(use fit_model for one)")
        generator = self._default_generator(generator)
        grid = self.grid
        self._log_grid()
        if grid is not None and nensembles % grid.size:
            new = -(-nensembles // grid.size) * grid.size
            self.log.info("Rounding nensembles %d -> %d (multiple of the "
                          "%d-rank grid)" % (nensembles, new, grid.size))
            nensembles = new
        # a grid's rank runs whole W-walker ensembles: the meshless engine
        lnprob = (self.lnprob_batch() if grid is None
                  else self._meshless_batch())
        ndim = self.layout.ndim
        thin, nsteps_exec = self._steps_exec()

        def start():
            return torch.stack([self._initial_positions(generator)
                                for _ in range(nensembles)])

        def runner(p, gen, n, sel=None):
            kw = dict(thin=thin, move=cfg.move, de_prob=cfg.de_prob,
                      de_sel=sel)
            if grid is None:
                return run_stretch_ensembles(lnprob, p, gen, n, **kw)
            from lumfuncmcmc_tpu_torch.parallel.sharding import (
                run_stretch_ensembles_sharded)
            return run_stretch_ensembles_sharded(lnprob, p, gen, n, grid,
                                                 **kw)

        self.log.info(
            "Fitting %d independent replicated ensembles x %d walkers "
            "(engine: %s, device: %s)%s" % (
                nensembles, cfg.nwalkers, getattr(lnprob, "engine", "eager"),
                self.device, "" if grid is None
                else " sharded over %d ranks" % grid.size))
        every = cfg.checkpoint_every or 0
        nsteps_run = nsteps_exec
        _sync(self.device)
        t0 = time.perf_counter()
        if min_ess:
            chains, lnps, acc, nsteps_run = self._ensembles_until(
                runner, start, nensembles, float(min_ess), int(max_blocks),
                thin, nsteps_exec, npz_path(checkpoint_path), resume, ndim)
        elif 0 < every < nsteps_exec:
            chains, lnps, acc = self._run_checkpointed(
                runner, start, nsteps_exec, thin, every, checkpoint_path,
                resume, "ensemble-checkpoint", ENS_TAG,
                fields=[("nensembles", nensembles)], step_axis=1)
        else:
            _, chains, lnps, acc = runner(start(), generator, nsteps_exec)
            chains, lnps, acc = _host(chains), _host(lnps), _host(acc)
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        self.log.info("Total time taken: %0.4f s" % elapsed)
        self.log.info("lnprob evaluations/s: %0.1f"
                      % (nensembles * cfg.nwalkers * nsteps_run / elapsed))

        # burn-in from the pooled walker view, applied to every ensemble
        pooled = np.moveaxis(chains, 0, 1).reshape(
            chains.shape[1], -1, ndim)              # (nsteps, E*W, D)
        burn, tau = burnin_steps(pooled, pooled.shape[0])
        self.acceptance_fraction = float(np.mean(acc) / nsteps_run)
        if chains.shape[1] - burn >= 2:
            rhat_ens = gelman_rubin_ensembles(chains[:, burn:])
        else:
            self.log.warning(
                "post-burn-in chain has <2 recorded steps — "
                "cross-ensemble R-hat undefined (run longer)")
            rhat_ens = np.full(ndim, np.nan)
        ess = effective_sample_size(pooled[burn:])
        self.log.info("Mean acceptance fraction: %0.4f" %
                      self.acceptance_fraction)
        self.log.info("AutoCorrelation Steps: %i, Number of Burn-in "
                      "Steps: %i" % (round(tau), burn))
        self.log.info("min ESS: %.0f; max cross-ensemble R-hat: %.4f "
                      "(%d ensembles); ESS/sec: %.0f"
                      % (ess.min(), rhat_ens.max(), nensembles,
                         ess.min() / elapsed))
        if chains.shape[1] - burn >= 4:
            self.log.info(
                "rank-normalized cross-ensemble R-hat (bulk/tail max): "
                "%.4f" % rank_normalized_rhat_ensembles(
                    chains[:, burn:]).max())
            self._log_convergence(pooled[burn:], rhat_line=False)
        self.rhat_ensembles = rhat_ens
        pooled_lnps = np.moveaxis(lnps, 0, 1).reshape(lnps.shape[1], -1)
        return self._set_samples(pooled, pooled_lnps, burn, ndim)

    def _ensembles_until(self, runner, start, nensembles, min_ess,
                         max_blocks, thin, nsteps_exec, checkpoint_path,
                         resume, ndim):
        """The min-ess block loop of :meth:`fit_model_ensembles`:
        ``(chains, lnps, acc, steps run)``."""
        cfg = self.cfg
        want, names = self._ens_fingerprint(
            [("nwalkers", cfg.nwalkers), ("thin", thin),
             ("block_steps", nsteps_exec), ("nensembles", nensembles)])
        ch_parts, lnp_parts, accs = [], [], []

        def pooled_ess():
            chains = np.concatenate(ch_parts, axis=1)
            pooled = np.moveaxis(chains, 0, 1).reshape(chains.shape[1], -1,
                                                       ndim)
            return self._min_ess(pooled)[0], pooled.shape[0]

        nblk, ess_now = 0, 0.0
        ck = self._resume_from(checkpoint_path, resume, want, names,
                               "ensemble-min-ess")
        if ck is not None:
            ch_parts, lnp_parts = [ck["chain"]], [ck["lnprobability"]]
            accs = list(ck["acc_blocks"])
            pos = torch.as_tensor(ck["chain"][:, -1], dtype=self.dtype,
                                  device=self.device)
            nblk = len(accs)
            ess_now, nrec = pooled_ess()
            self.log.info("Resumed ensemble-min-ess checkpoint: %d blocks "
                          "(%d recorded steps), pooled min ESS=%.0f"
                          % (nblk, nrec, ess_now))
        else:
            pos = start()
        while not ch_parts or (ess_now < min_ess and nblk < max_blocks):
            gen = stream_generator(cfg.seed, ENS_TAG, self.device, nblk)
            state, ch, lp, ac = runner(pos, gen, nsteps_exec,
                                       self._sel(nsteps_exec,
                                                 nblk * nsteps_exec))
            nblk += 1
            pos = state.pos
            ch_parts.append(_host(ch))
            lnp_parts.append(_host(lp))
            accs.append(_host(ac))
            if checkpoint_path:
                _save(checkpoint_path,
                      chain=np.concatenate(ch_parts, axis=1),
                      lnprobability=np.concatenate(lnp_parts, axis=1),
                      acc_blocks=np.stack(accs), fingerprint=want)
            ess_now, nrec = pooled_ess()
            self.log.info("Ensembles block %d: %d recorded steps, pooled "
                          "min ESS=%.0f (target %.0f)"
                          % (nblk, nrec, ess_now, min_ess))
        return (np.concatenate(ch_parts, axis=1),
                np.concatenate(lnp_parts, axis=1),
                np.sum(np.stack(accs), axis=0), nblk * nsteps_exec)
