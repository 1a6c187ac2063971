"""Run the port on several CPU ranks for the parity tests: gloo over a
``file://`` rendezvous in the test's temporary directory (no TCP port, so
no clash between pytest-xdist workers), one torch thread a rank, no card.

``start_ranks(tmp_path, worker, inputs, world_size=2)`` writes ``inputs``
(arrays, or JSON values) to ``tmp_path`` and starts ``world_size``
processes running ``python _torch_dist.py <worker> <rank> <world_size>
<dir>``; its ``wait()`` returns each rank's outputs (``run_ranks`` does
both), so a test computes its JAX oracle while the ranks run. A rank runs
``WORKERS[worker](inputs, rank)`` after
joining the world (``trex_tpu_torch.parallel.initialize_distributed``,
with a timeout) and saves the dict of arrays it returns. The workers
import torch, numpy and the port only: the parent test holds their
outputs against the JAX package.

A rank that fails makes ``run_ranks`` kill the others at once and raise
with its traceback, and the whole world has a wall limit, so no test hangs
on a rank that died inside a collective.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parent


class Ranks:
    """A running world of ranks (``start_ranks``); ``wait()`` returns each
    rank's output arrays or raises with a failed rank's log."""

    def __init__(self, tmp_path, worker: str, inputs: dict, world_size: int, timeout: float):
        self.worker, self.world_size = worker, world_size
        self.work = work = Path(tmp_path) / f"ranks_{worker}_{time.monotonic_ns()}"
        work.mkdir(parents=True)
        arrays = {k: np.asarray(v) for k, v in inputs.items()
                  if not isinstance(v, (dict, list, str))}
        config = {k: v for k, v in inputs.items() if k not in arrays}
        np.savez(work / "inputs.npz", **arrays)
        (work / "config.json").write_text(json.dumps(config))
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(_REPO), env.get("PYTHONPATH", "")]))
        self.procs = []
        for rank in range(world_size):
            log = open(work / f"log_{rank}.txt", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, str(_HERE / "_torch_dist.py"), worker, str(rank),
                 str(world_size), str(work)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(work)), log))
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list[dict]:
        def failed():
            return next((r for r, (p, _) in enumerate(self.procs) if p.poll()), None)

        try:
            while (any(p.poll() is None for p, _ in self.procs) and failed() is None
                   and time.monotonic() < self.deadline):
                time.sleep(0.05)
        finally:
            for p, log in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        rank = failed()
        if rank is not None:
            raise AssertionError(f"rank {rank} of {self.worker} failed:\n"
                                 + (self.work / f"log_{rank}.txt").read_text())
        outs = [self.work / f"out_{r}.npz" for r in range(self.world_size)]
        if not all(path.exists() for path in outs):
            raise AssertionError(f"{self.worker} did not finish within its time limit")
        return [_load(path) for path in outs]


def _load(path) -> dict:
    with np.load(path, allow_pickle=False) as arrays:
        return dict(arrays)


def start_ranks(tmp_path, worker: str, inputs: dict, world_size: int = 2,
                timeout: float = 90.0) -> Ranks:
    """Start ``world_size`` ranks running ``WORKERS[worker]`` on ``inputs``
    (a dict of arrays or JSON-able values); the caller may compute its
    oracle meanwhile, then ``wait()``."""
    return Ranks(tmp_path, worker, inputs, world_size, timeout)


def run_ranks(tmp_path, worker: str, inputs: dict, world_size: int = 2,
              timeout: float = 90.0) -> list[dict]:
    """Each rank's output arrays of ``WORKERS[worker]`` on ``inputs``."""
    return start_ranks(tmp_path, worker, inputs, world_size, timeout).wait()


def _main(worker: str, rank: int, world_size: int, work: str) -> None:
    import torch

    from trex_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    inputs = _load(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "config.json")) as fh:
        inputs.update(json.load(fh))
    initialize_distributed(f"file://{work}/rdv", world_size, rank,
                           initialization_timeout=60, device="cpu")
    out = WORKERS[worker](inputs, rank)
    np.savez(os.path.join(work, f"out_{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


WORKERS: dict = {}


def worker(fn):
    """Register ``fn(inputs, rank) -> dict of arrays`` as a worker."""
    WORKERS[fn.__name__] = fn
    return fn


@worker
def cli(inputs: dict, rank: int) -> dict:
    """The port's CLI on each of ``inputs["argvs"]`` (every rank runs each
    command, from a directory of its own, so relative output paths show
    which rank wrote): the stdout of each (``stdout_<i>``) and the text of
    each file ``inputs["files"][i]`` names after it (``file_<i>_<name>``,
    "" when the rank wrote none). ``draws_<seed>`` arrays replace the
    bootstrap's draws of a generator seeded ``<seed>``; ``au_off`` turns
    the topology tests' AU scales off."""
    import contextlib
    import io

    import torch

    import trex_tpu_torch.search.bootstrap as torch_bootstrap
    import trex_tpu_torch.search.topotest as torch_topotest
    from trex_tpu_torch.cli.parser import main

    def draws(length, n_replicates, site_weights, generator):
        return torch.as_tensor(inputs[f"draws_{generator.initial_seed()}"])

    torch_bootstrap._replicate_weights = draws
    if inputs.get("au_off"):
        torch_topotest.topology_tests.__kwdefaults__["au_scales"] = None
    os.makedirs(f"rank{rank}")
    os.chdir(f"rank{rank}")
    out = {}
    for i, argv in enumerate(inputs["argvs"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        out[f"stdout_{i}"] = buf.getvalue()
        for name in inputs["files"][i]:
            text = ""
            if os.path.exists(name):
                with open(name) as fh:
                    text = fh.read()
            out[f"file_{i}_{name}"] = text
    return out


class ReplayDraws:
    """The samplers' draw protocol (``search/mcmc.py``'s ``TorchDraws``)
    replaying a recording (``_torch_parity.RecordedDraws``, under
    ``prefix`` in ``inputs``) call by call: each call must be the recorded
    call's kind and shape (the whole batch's), and a Dirichlet's
    concentrations the recorded ones; ``get_state`` gives the key state
    recorded at this call, ``set_state`` moves to the call recorded with
    that state."""

    def __init__(self, inputs: dict, prefix: str) -> None:
        self.calls = inputs[f"{prefix}_calls"]
        sizes = [int(np.prod(shape)) for _, shape in self.calls]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.values = inputs[f"{prefix}_values"]
        self.alphas = inputs[f"{prefix}_alphas"]
        self.state_at = inputs[f"{prefix}_state_at"]
        self.states = inputs[f"{prefix}_states"]
        self.pos = self.alpha_pos = 0

    def _next(self, kind: str, shape):
        import torch

        got_kind, got_shape = self.calls[self.pos]
        assert (kind, list(shape)) == (got_kind, got_shape), \
            f"call {self.pos}: {kind} {list(shape)}, recorded {got_kind} {got_shape}"
        x = self.values[self.offsets[self.pos]:self.offsets[self.pos + 1]].reshape(shape)
        self.pos += 1
        return torch.as_tensor(x, dtype=torch.int64 if kind == "randint" else torch.float32)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, shape, low, high):
        return self._next("randint", shape)

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def gamma(self, concentration, shape):
        return self._next("gamma", shape)

    def dirichlet(self, alpha):
        n = alpha.numel()
        want = self.alphas[self.alpha_pos:self.alpha_pos + n]
        np.testing.assert_array_equal(alpha.numpy().ravel(), want, err_msg="Dirichlet alpha")
        self.alpha_pos += n
        return self._next("dirichlet", alpha.shape)

    def get_state(self):
        return self.states[list(self.state_at).index(self.pos)]

    def set_state(self, state) -> None:
        i = next(i for i, st in enumerate(self.states) if np.array_equal(st, state))
        self.pos = int(self.state_at[i])
        self.alpha_pos = sum(int(np.prod(shape)) for kind, shape in self.calls[:self.pos]
                             if kind == "dirichlet")


MESHES = {"t2": 2, "s2": 1}
"""The meshes a two-rank world runs, by name: tree parallelism 2 ((2, 1))
and 1 ((1, 2)). Both are built in one world."""


def _meshes():
    from trex_tpu_torch.parallel import make_mesh

    return {name: make_mesh(tree_parallelism=t) for name, t in MESHES.items()}


@worker
def sharded(inputs: dict, rank: int) -> dict:
    """``parallel.sharded``'s functions on each mesh: batch scores (K1 and
    K5 paths, states and masks), the best tree of a batch with a planted
    tie, JC log-likelihoods, per-site rows, and the parsimony and ML scans
    (whole, in several segments, and reduced to the best move)."""
    import torch

    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.topology import Topology

    t = {k: torch.as_tensor(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    batch = Topology(t["children"], t["parents"])
    tie = Topology(t["tie_children"], t["tie_parents"])
    trees = Topology(t["ps_children"], t["ps_parents"])
    scan_tree = Topology(t["scan_children"], t["scan_parents"])
    hamming = torch.ones((4, 4)) - torch.eye(4)
    cells = 3 * scan_tree.n_all  # three prune rows a segment
    out = {}
    for name, mesh in _meshes().items():
        w = t["weights"]
        out[f"{name}_fitch"] = sh.sharded_batch_scores(mesh, batch, hamming, t["states"],
                                                       site_weights=w)
        out[f"{name}_fitch_masks"] = sh.sharded_batch_scores(
            mesh, batch, hamming, t["masks"], site_weights=w, sequences_are_masks=True)
        out[f"{name}_sankoff"] = sh.sharded_batch_scores(mesh, batch, t["tt"], t["states"],
                                                         site_weights=w)
        out[f"{name}_sankoff_masks"] = sh.sharded_batch_scores(
            mesh, batch, t["tt"], t["masks"], site_weights=w, sequences_are_masks=True)
        out[f"{name}_sankoff_forced"] = sh.sharded_batch_scores(
            mesh, batch, hamming, t["states"], use_fitch=False, site_weights=w)
        idx, score = sh.sharded_best_tree(mesh, tie, hamming, t["states"])
        out[f"{name}_best"] = np.array([int(idx), float(score)])
        out[f"{name}_lnl"] = sh.sharded_log_likelihoods(
            mesh, batch, t["blens"], t["masks"], 4, site_weights=w, sequences_are_masks=True)
        out[f"{name}_per_site"] = sh.sharded_per_site_matrix(
            mesh, trees, t["masks"], 4, weights=t["ps_weights"], n_sweeps=3,
            sequences_are_masks=True)
        kw = dict(sequences_are_masks=True)
        for tag, extra in (("", {}), ("_seg", {"max_cells": cells})):
            table, base = sh.sharded_spr_scan(mesh, scan_tree, t["masks"], w, **kw, **extra)
            out[f"{name}_scan{tag}"], out[f"{name}_scan{tag}_base"] = table, base
            out[f"{name}_best_pars{tag}"] = np.array(sh.sharded_spr_scan_best(
                mesh, scan_tree, t["masks"], w, **kw, **extra), np.float64)
            table, base = sh.sharded_spr_scan(mesh, scan_tree, t["masks"], w, criterion="ml",
                                              n_states=4, **kw, **extra)
            out[f"{name}_ml_scan{tag}"], out[f"{name}_ml_scan{tag}_base"] = table, base
            out[f"{name}_best_ml{tag}"] = np.array(sh.sharded_spr_scan_best(
                mesh, scan_tree, t["masks"], w, criterion="ml", n_states=4, **kw, **extra),
                np.float64)
        out[f"{name}_best_const"] = np.array(sh.sharded_spr_scan_best(
            mesh, scan_tree, t["const_masks"], None, max_cells=cells, **kw), np.float64)
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def _topology(inputs: dict, prefix: str):
    import torch

    from trex_tpu_torch.topology import Topology

    return Topology(torch.as_tensor(inputs[f"{prefix}_children"]),
                    torch.as_tensor(inputs[f"{prefix}_parents"]))


@worker
def search(inputs: dict, rank: int) -> dict:
    """The wired search paths with ``mesh=`` on each mesh: the parsimony
    climbs (NNI, SPR scan), the ratchet and the bootstrap under given
    draws, SPR-decay, the ML scan climb and the ML bootstrap."""
    import torch

    from trex_tpu_torch.search.bootstrap import bootstrap_analysis, ml_bootstrap_analysis
    from trex_tpu_torch.search.bremer import spr_decay_support
    from trex_tpu_torch.search.hillclimb import parsimony_hill_climb
    from trex_tpu_torch.search.ml import ml_hill_climb
    from trex_tpu_torch.search.ratchet import parsimony_ratchet

    start = _topology(inputs, "start")
    masks = torch.as_tensor(inputs["masks"])
    w = torch.as_tensor(inputs["weights"])
    hamming = torch.ones((4, 4)) - torch.eye(4)
    kw = dict(site_weights=w, sequences_are_masks=True, device="cpu")
    out = {}

    def result(name, res):
        out[f"{name}_children"] = res.topology.children.numpy()
        out[f"{name}_numbers"] = np.array([res.score, res.rounds, res.evaluations])
        out[f"{name}_trace"] = np.array(res.trace)

    for name, mesh in _meshes().items():
        for nbhd in ("nni", "spr-scan"):
            result(f"{name}_{nbhd}", parsimony_hill_climb(
                start, hamming, masks, max_rounds=6, neighborhood=nbhd, mesh=mesh, **kw))
        result(f"{name}_ratchet", parsimony_ratchet(
            start, hamming, masks, upweighted=inputs["upweighted"], n_iterations=2,
            climb_rounds=4, neighborhood="nni", mesh=mesh, **kw))
        support, best = bootstrap_analysis(
            start, hamming, masks, n_replicates=3, search_rounds=3,
            replicate_weights=inputs["replicates"], mesh=mesh, **kw)
        out[f"{name}_bootstrap"] = support
        out[f"{name}_bootstrap_trees"] = np.stack([t.children.numpy() for t in best])
        decay, base = spr_decay_support(start, masks, w, sequences_are_masks=True, mesh=mesh)
        out[f"{name}_decay"], out[f"{name}_decay_base"] = decay, np.array(base)
        res, lengths, losses = ml_hill_climb(
            start, masks, 4, neighborhood="spr-scan", max_rounds=4, mesh=mesh, **kw)
        result(f"{name}_ml", res)
        out[f"{name}_ml_lengths"], out[f"{name}_ml_losses"] = lengths.numpy(), losses.numpy()
        support, best = ml_bootstrap_analysis(
            start, masks, 4, n_replicates=3, search_rounds=3,
            replicate_weights=inputs["replicates"], mesh=mesh, **kw)
        out[f"{name}_ml_bootstrap"] = support
        out[f"{name}_ml_bootstrap_trees"] = np.stack([t.children.numpy() for t in best])
    return out


@worker
def supports(inputs: dict, rank: int) -> dict:
    """The likelihood supports with ``mesh=`` on each mesh under given
    draws: aLRT / SH-aLRT, UFBoot on given candidates, the topology tests."""
    import torch

    from trex_tpu_torch.search.alrt import branch_supports
    from trex_tpu_torch.search.topotest import topology_tests
    from trex_tpu_torch.search.ufboot import ultrafast_bootstrap

    t = {k: torch.as_tensor(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    out = {}
    for name, mesh in _meshes().items():
        kw = dict(n_sweeps=3, sequences_are_masks=True, mesh=mesh)
        alrt = branch_supports(_topology(inputs, "alrt"), t["alrt_masks"], 4,
                               site_weights=t["alrt_weights"],
                               replicate_weights=inputs["alrt_draws"], **kw)
        out.update({f"{name}_alrt": alrt.alrt, f"{name}_sh": alrt.sh_alrt,
                    f"{name}_rell": alrt.rell, f"{name}_alrt_ll": np.array(alrt.log_likelihood)})
        ub = ultrafast_bootstrap(_topology(inputs, "ub"), t["ub_masks"], 4,
                                 candidates=_topology(inputs, "ub_cand"),
                                 site_weights=t["ub_weights"],
                                 replicate_weights=inputs["ub_draws"], **kw)
        out.update({f"{name}_ub_support": ub.support, f"{name}_ub_wins": ub.winner_counts,
                    f"{name}_ub_ll": ub.log_likelihoods})
        tt = topology_tests(_topology(inputs, "tt"), t["tt_masks"], 4,
                            site_weights=t["tt_weights"], replicate_weights=inputs["tt_draws"],
                            au_scales=None, **kw)
        out.update({f"{name}_tt_{k}": np.asarray(getattr(tt, k)) for k in (
            "log_likelihoods", "delta", "p_kh", "p_sh", "bp", "elw", "best_index")})
    return out


@worker
def joint(inputs: dict, rank: int) -> dict:
    """The sharded joint steps (one restart; a restart batch) from given
    parameters and noise, each rank on its shard, the parameters gathered
    back; and ``joint_search`` and ``fit_topology`` with ``mesh=`` under
    given draws."""
    import torch

    from trex_tpu_torch.parallel import sharded as sh
    from trex_tpu_torch.search.joint import JointConfig, fit_topology, joint_search
    from trex_tpu_torch.search.optimizers import make_optimizer

    t = {k: torch.as_tensor(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    leaf, n_leaves = t["leaf"], (t["leaf"].shape[0] + 1) // 2
    out = {}

    def gathered(mesh, params, restarts):
        anc = torch.cat(list(mesh.all_gather(params["ancestors"].detach(), "site")), dim=-2)
        tree = params["tree_params"].detach()
        if restarts:
            anc = torch.cat(list(mesh.all_gather(anc, "tree")))
            tree = torch.cat(list(mesh.all_gather(tree, "tree")))
        return anc, tree

    for name, mesh in _meshes().items():
        params, shard = sh.shard_joint_params(
            mesh, {"tree_params": t["tree_params"], "ancestors": t["ancestors"]}, leaf)
        opt = make_optimizer("adam", 0.01, params.values(), clip_global_norm=None)
        out[f"{name}_step_loss"] = sh.sharded_joint_step(mesh, params, shard, t["noise"], 1.0,
                                                         opt, n_leaves)
        out[f"{name}_step_anc"], out[f"{name}_step_tree"] = gathered(mesh, params, False)

        params, shard = sh.shard_joint_params(
            mesh, {"tree_params": t["r_tree_params"], "ancestors": t["r_ancestors"]}, leaf,
            restarts=True)
        opt = make_optimizer("adam", 0.01, params.values(), clip_global_norm=None,
                             batched=True)
        step = sh.make_sharded_restart_joint_step(mesh, opt, n_leaves)
        rows = sh.tree_block(mesh, t["r_noise"])
        losses = step(params, shard, rows, torch.tensor(1.0))
        out[f"{name}_rstep_loss"] = torch.cat(list(mesh.all_gather(losses, "tree")))
        out[f"{name}_rstep_anc"], out[f"{name}_rstep_tree"] = gathered(mesh, params, True)

        cfg = JointConfig(n_iterations=int(inputs["n_iterations"]))
        params, losses, score = joint_search(
            leaf, t["cost"], cfg, n_restarts=4, mesh=mesh,
            init={"tree_params": t["s_tree"], "ancestors": t["s_anc"]},
            noise=t["s_noise"], eval_noise=t["s_eval"])
        out.update({f"{name}_search_{k}": v for k, v in params.items()})
        out[f"{name}_search_losses"], out[f"{name}_search_score"] = losses, score
        params, losses = fit_topology(t["f_seqs"], n_iterations=int(inputs["n_iterations"]),
                                      n_restarts=4, init=t["f_tree"], noise=t["f_noise"],
                                      eval_noise=t["f_eval"], mesh=mesh)
        out[f"{name}_fit_tree"], out[f"{name}_fit_losses"] = params["tree_params"], losses
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}

@worker
def samplers(inputs: dict, rank: int) -> dict:
    """``mcmc_sample``, ``mcmc_date`` and ``stepping_stone`` with ``mesh=``
    under replayed draws, one run for each entry of ``inputs["runs"]``
    (``name``, ``kind``, ``mesh``, ``draws``, ``kwargs``; an mcmc run's
    ``checkpoint`` directory, shared by the ranks, which rank 0 first
    fills with ``inputs["<seed>_<key>"]`` when ``seed`` names them): the
    results and an mcmc run's final checkpoint."""
    import torch
    import torch.distributed as dist

    from trex_tpu_torch.search.dating import mcmc_date
    from trex_tpu_torch.search.marginal import stepping_stone
    from trex_tpu_torch.search.mcmc import mcmc_sample

    meshes = _meshes()
    topo = _topology(inputs, "tree")
    common = dict(site_weights=inputs["weights"], sequences_are_masks=True, device="cpu")
    out = {}
    for run in inputs["runs"]:
        name = run["name"]
        kw = dict(run["kwargs"], draws=ReplayDraws(inputs, run["draws"]),
                  mesh=meshes[run["mesh"]], **common)
        if run["kind"] == "mcmc":
            ck = run["checkpoint"]
            if run.get("seed") and rank == 0:
                os.makedirs(ck)
                np.savez(os.path.join(ck, "mcmc_checkpoint.npz"),
                         **{k[len(run["seed"]) + 1:]: v for k, v in inputs.items()
                            if k.startswith(run["seed"] + "_")})
            dist.barrier()
            res = mcmc_sample(inputs["leaves"], 4, checkpoint_dir=ck, **kw)
            out.update({f"{name}_{k}": np.asarray(getattr(res, k)) for k in (
                "sample_children", "sample_lengths", "sample_lnl", "sample_run",
                "consensus_newick", "ess_lnl", "mean_lengths")})
            out[f"{name}_asdsf"] = np.asarray(np.nan if res.asdsf is None else res.asdsf)
            out[f"{name}_acceptance"] = np.array(list(res.acceptance.values()))
            with np.load(os.path.join(ck, "mcmc_checkpoint.npz")) as saved:
                out.update({f"{name}_ck_{k}": v for k, v in saved.items()})
        elif run["kind"] == "date":
            res = mcmc_date(topo, inputs["leaves"], 4, start_ages=inputs["ages"], **kw)
            out.update({f"{name}_{k}": np.asarray(getattr(res, k)) for k in (
                "sample_ages", "sample_lnl", "age_hpd", "ess_root_age")})
            out[f"{name}_acceptance"] = np.array(list(res.acceptance.values()))
        else:
            res = stepping_stone(topo, inputs["leaves"], 4, **kw)
            out.update({f"{name}_{k}": np.asarray(v) for k, v in res.items()})
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


if __name__ == "__main__":
    sys.path.insert(0, str(_HERE))
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
