"""The port's ``infer --start diff`` against trex_tpu's, and the keys of its
``search``, ``asr``, ``nk-bench`` and ``search-run`` commands.

The JAX commands' bodies run as they are to print their keys, with their
searches replaced by stand-ins that return arrays of the right shapes, so
that the test compiles none of JAX's descents: the port's numbers are held
to those searches in ``test_torch_joint.py`` and ``test_torch_nk.py``.

``diff_start`` is handed the JAX start's own draws: the restarts' initial
parameters, each step's Gumbel noise (``joint_optimize``'s step keys) and
the projection noise, split from ``key(seed)`` and ``key(seed + 1)``
exactly as ``trex_tpu/cli/_common.py`` splits them. It must return JAX's
eight projected trees (children and parents) and their exact scores (K1's
plain version here, JAX's Fitch dispatch there) and pick the same tree.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks

from trex_tpu.cli.parser import build_parser as jax_parser
from trex_tpu.ops.dispatch import batched_scores_fastest as jax_scores
from trex_tpu.ops.relax import project_topology as jax_project
from trex_tpu.ops.relax import soft_topology as jax_soft_topology
from trex_tpu.search import joint as jax_joint
from trex_tpu.types import CostModel as JaxCostModel
from trex_tpu_torch.cli import build_parser
from trex_tpu_torch.cli._common import DIFF_ITERATIONS, DIFF_RESTARTS, diff_start
from trex_tpu_torch.search.joint import params_from_numpy

N_TAXA, N_SITES, SEED = 8, 64, 3


def _jax_diff(masks, weights):
    """JAX's ``--start diff`` pipeline, with its draws: (children, parents,
    scores, init, step noise, projection noise)."""
    n_all = 2 * N_TAXA - 1
    ints = np.zeros_like(masks)
    lsb = masks & -masks
    for b in range(4):
        ints[lsb == (1 << b)] = b
    leaf_tensor = jnp.zeros((n_all, N_SITES, 4)).at[:N_TAXA].set(jax.nn.one_hot(ints, 4))
    cfg = jax_joint.JointConfig(n_iterations=DIFF_ITERATIONS)
    shape = (n_all - 1, N_TAXA - 1)

    def one_restart(key):
        k_init, k_run = jax.random.split(key)
        params = jax_joint.init_params(k_init, N_TAXA, N_SITES, 4)
        noise = jax.vmap(lambda k: jax.random.gumbel(k, shape))(
            jax.random.split(k_run, DIFF_ITERATIONS))
        return jax_joint.joint_optimize(k_run, params, leaf_tensor, cfg)[0], params, noise

    def project(p, k):
        return jax_project(jax_soft_topology(k, p["tree_params"], 0.01)), jax.random.gumbel(k, shape)

    keys = jax.random.split(jax.random.key(SEED), DIFF_RESTARTS)
    params, init, noise = jax.jit(jax.vmap(one_restart))(keys)
    topos, proj_noise = jax.jit(jax.vmap(project))(
        params, jax.random.split(jax.random.key(SEED + 1), DIFF_RESTARTS))
    scores = jax_scores(topos, JaxCostModel.hamming(4).matrix, jnp.asarray(masks),
                        site_weights=jnp.asarray(weights), sequences_are_masks=True)
    return (np.asarray(topos.children), np.asarray(topos.parents), np.asarray(scores),
            init, np.asarray(noise).swapaxes(0, 1), np.asarray(proj_noise))


def test_diff_start_gives_jax_trees_and_scores():
    rng = np.random.default_rng(SEED)
    masks = random_masks(rng, N_TAXA, N_SITES, ambiguity=0.05)
    weights = rng.integers(1, 4, N_SITES).astype(np.float32)
    children, parents, scores, init, noise, proj_noise = _jax_diff(masks, weights)
    got = diff_start(masks, 4, SEED, torch.tensor(weights), torch.device("cpu"),
                     init=params_from_numpy(init), noise=torch.tensor(noise),
                     projection_noise=torch.tensor(proj_noise))
    np.testing.assert_array_equal(got.trees.children.numpy(), children)
    np.testing.assert_array_equal(got.trees.parents.numpy(), parents)
    np.testing.assert_array_equal(got.scores.numpy(), scores)
    best = int(np.argmin(scores))
    np.testing.assert_array_equal(got.topology.children.numpy(), children[best])


def _write_fasta(path, rng):
    letters = np.array(list("ACGT"))
    root = rng.integers(0, 4, N_SITES)
    with open(path, "w") as fh:
        for t in range(N_TAXA):
            seq = root.copy()
            hit = rng.random(N_SITES) < 0.3
            seq[hit] = rng.integers(0, 4, int(hit.sum()))
            fh.write(f">t{t}\n{''.join(letters[seq])}\n")


def _out(parser, argv):
    """The last JSON line a command prints."""
    args = parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        args.fn(args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_infer_start_diff_on_cpu(tmp_path):
    """The command runs the diff start and its climb on the CPU and prints a
    stepwise run's keys and a tree of every taxon."""
    fasta = tmp_path / "aln.fasta"
    _write_fasta(fasta, np.random.default_rng(1))
    diff = _out(build_parser, ["infer", "--alignment", str(fasta), "--start", "diff",
                               "--device", "cpu"])
    stepwise = _out(build_parser, ["infer", "--alignment", str(fasta), "--device", "cpu"])
    assert list(diff) == list(stepwise)
    assert diff["start"] == "diff" and diff["parsimony_score"] > 0
    assert all(f"t{t}" in diff["tree"] for t in range(N_TAXA))


def _jax_stand_ins(monkeypatch):
    """Replace the JAX searches the commands call with shape-right stubs."""
    from trex_tpu.models import nk as jax_nk
    from trex_tpu.search import asr as jax_asr
    from trex_tpu.search import runner as jax_runner

    def ancestors(leaf, n_all, *args, **kwargs):
        return jnp.zeros((n_all - leaf.shape[0], leaf.shape[1]), jnp.int32)

    monkeypatch.setattr(jax_joint, "joint_search", lambda key, leaf, cost, cfg, n_restarts: (
        None, jnp.zeros((cfg.n_iterations,)), jnp.float32(0)))
    monkeypatch.setattr(jax_asr, "reconstruct_ancestors", ancestors)
    monkeypatch.setattr(jax_asr, "reconstruct_ancestors_landscape_aware", ancestors)
    monkeypatch.setattr(jax_nk, "evolve_tree", lambda landscape, topo, root, *a, **k: jnp.zeros(
        (topo.n_all, root.shape[-1]), jnp.int32))
    monkeypatch.setattr(jax_runner, "run_search", lambda cfg, leaf, resume=True: None)


@pytest.mark.parametrize("argv", [
    ["search", "--leaves", "4", "--sites", "8", "--iterations", "3", "--restarts", "2"],
    ["asr", "--leaves", "4", "--sites", "8", "--iterations", "3"],
    ["nk-bench", "--leaves", "4", "--sites", "8", "--k-values", "1", "--lambdas", "0", "0.3",
     "--iterations", "3"],
    ["search-run", "--leaves", "4", "--sites", "8", "--iterations", "4",
     "--checkpoint-every", "2"],
], ids=["search", "asr", "nk-bench", "search-run"])
def test_commands_print_the_jax_keys(argv, tmp_path, monkeypatch):
    _jax_stand_ins(monkeypatch)
    if argv[0] == "search-run":
        argv = argv + ["--workdir", str(tmp_path / "run")]
    want = _out(jax_parser, argv)
    if argv[0] == "search-run":
        argv[-1] = str(tmp_path / "port")
    got = _out(build_parser, argv + ["--device", "cpu"])
    assert list(got) == list(want)
    if argv[0] == "nk-bench":
        assert list(got["K=1"]) == list(want["K=1"])
