"""Argument parser and entry point (counterpart of ``trex_tpu/cli/parser.py``;
the ``score``, ``infer``, ``partition``, ``modeltest``, ``search``, ``asr``,
``search-run``, ``bench``, ``ml``, ``bootstrap``, ``nk-bench``, ``trait``,
``treedist``, ``consensus``, ``treedraw``, ``stats``, ``treeprune``,
``topotest``, ``concord``, ``mcmc``, ``bayesfactor``, ``date``, ``dnds`` and
``simulate`` commands: all of the JAX package's)."""

from __future__ import annotations

import argparse

import torch

import trex_tpu_torch.cli as _cli_pkg
from trex_tpu_torch.cli._common import _add_common, _add_device, _add_mesh_flag, refuse_world
from trex_tpu_torch.cli.bayes import cmd_bayesfactor, cmd_concord, cmd_date, cmd_mcmc
from trex_tpu_torch.cli.infer import cmd_infer
from trex_tpu_torch.cli.models import cmd_dnds, cmd_modeltest, cmd_partition
from trex_tpu_torch.cli.score import cmd_asr, cmd_score, cmd_stats, cmd_trait, cmd_treedraw
from trex_tpu_torch.cli.simulate import cmd_simulate
from trex_tpu_torch.cli.search_cmds import (
    cmd_bench,
    cmd_bootstrap,
    cmd_ml,
    cmd_nk_bench,
    cmd_search,
    cmd_search_run,
)
from trex_tpu_torch.cli.trees import cmd_consensus, cmd_topotest, cmd_treedist, cmd_treeprune


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trex_tpu_torch", description=_cli_pkg.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("score", help="exact Sankoff scoring + reconstruction")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str,
                   default=None,
                   help="score a real alignment (FASTA/PHYLIP/NEXUS, "
                        "auto-detected) instead of generated data")
    p.add_argument("--tree", type=str, default=None,
                   help="newick tree to score (default: stepwise addition)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--criterion", choices=("parsimony", "ml"),
                   default="parsimony",
                   help="ml = ML branch lengths + marginal posterior ASR")
    p.add_argument("--model", type=str, default="jc",
                   help="substitution model for --criterion ml "
                        "(jc|k80|hky|f81|tn93|gtr|empirical, +g/+g+i/+rK; "
                        "fitted before the ASR)")
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file for --model empirical")
    p.add_argument("--site-rates", type=str, default=None,
                   help="write posterior mean per-site rates here "
                        "(needs a rate-mixture model, e.g. gtr+g)")
    p.add_argument("--asr", choices=("marginal", "joint"), default="marginal",
                   help="ancestral reconstruction flavor for --criterion "
                        "ml: per-node marginal posteriors or the jointly "
                        "optimal assignment (Pupko max-product)")
    p.add_argument("--output-fasta", type=str, default=None,
                   help="write leaves + reconstructed ancestors here")
    _add_device(p, "the scoring")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("infer", help="infer a tree from an alignment file")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str,
                   required=True,
                   help="FASTA/PHYLIP/NEXUS alignment (auto-detected)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--criterion", choices=("parsimony", "ml", "distance"),
                   default="parsimony",
                   help="parsimony, ml, or distance (the NJ/UPGMA tree of "
                        "--start, default nj, with its own branch lengths)")
    p.add_argument("--model", default="jc",
                   help="substitution model fitted on the final ML tree: "
                        "jc|k80|hky|f81|tn93|gtr|empirical with optional "
                        "+g, +g+i, or +rK (FreeRate, K=2..8); 'empirical' "
                        "needs --model-file")
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file for --model empirical "
                        "(exchangeabilities + frequencies, e.g. LG/WAG .dat)")
    p.add_argument("--model-rounds", type=int, default=0,
                   help="ML model <-> tree iterations: re-search ranking "
                        "candidates under the fitted model, refit, repeat "
                        "until the topology is stable (needs a model with "
                        "free rates, e.g. gtr+g)")
    p.add_argument("--start",
                   choices=("stepwise", "nj", "upgma", "random", "balanced",
                            "diff"),
                   default="stepwise",
                   help="starting tree: stepwise addition (default); "
                        "random (a coalescent tree from --seed); balanced "
                        "(power-of-two taxon counts); or 'diff', the "
                        "differentiable joint relaxation as a coarse "
                        "initializer (8 restarts of 600 steps as one batch, "
                        "projected to valid trees, best exact score by the "
                        "Fitch kernel); nj/upgma: the distance tree of JC "
                        "distances (ambiguity resolved to the lowest state)")
    p.add_argument("--orders", type=int, default=4,
                   help="random addition orders for --start stepwise")
    p.add_argument("--constraint", type=str, default=None,
                   help="constraint newick: every visited tree keeps its "
                        "splits (needs --neighborhood nni/spr/tbr; under ml "
                        "--model jc only)")
    p.add_argument("--neighborhood",
                   choices=("spr-scan", "spr", "nni", "tbr"),
                   default="spr-scan",
                   help="spr-scan = analytic all-SPR evaluation; nni, spr, "
                        "tbr = enumerated neighborhoods (the native move "
                        "library), each round's batch scored by the Fitch "
                        "kernel (parsimony; tbr sampled to 16384 a round) or, "
                        "for nni, the likelihood kernel (ml; spr-scan ranks "
                        "under a fitted rate mixture in --model-rounds)")
    p.add_argument("--rounds", type=int, default=100,
                   help="max hill-climb rounds")
    p.add_argument("--ratchet", type=int, default=0,
                   help="parsimony-ratchet iterations, or under ml the "
                        "iterated ML search's (random kicks and reclimbs)")
    p.add_argument("--decay", action="store_true",
                   help="SPR-decay (approximate Bremer) support per split "
                        "(parsimony)")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="bootstrap replicates: split supports (on the newick "
                        "under parsimony and distance)")
    p.add_argument("--outgroup", type=str, default=None,
                   help="comma-separated outgroup taxa to root the tree on")
    p.add_argument("--alrt", type=int, default=0,
                   help="SH-aLRT / aLRT / RELL branch supports with this many "
                        "RELL replicates (ml): each NNI alternative's lengths "
                        "Newton-fitted in one batch, its per-site rows from the "
                        "likelihood kernel")
    p.add_argument("--ufboot", type=int, default=0,
                   help="ultrafast bootstrap supports (ml): RELL over the NNI "
                        "neighbourhood plus 64 sampled TBR trees, this many "
                        "replicates; its values label the newick")
    p.add_argument("--restarts", type=int, default=1,
                   help="independent searches: the --start tree plus N-1 "
                        "more (random-addition stepwise starts, or random "
                        "trees when --start is not stepwise); best final "
                        "score wins")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", type=str, default=None)
    _add_mesh_flag(p)
    _add_device(p, "the search")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser(
        "partition", help="partitioned ML fit (per-gene models, shared tree)")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str, required=True)
    p.add_argument("--partitions", type=str, required=True,
                   help="RAxML-style partition file (TYPE, name = ranges)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--tree", type=str, default=None,
                   help="fixed newick topology (default: stepwise start)")
    p.add_argument("--model", type=str, default="gtr+g",
                   help="model for every partition (unless --models)")
    p.add_argument("--models", type=str, default=None,
                   help="comma-separated per-partition model strings")
    p.add_argument("--linked", choices=("proportional", "equal"), default="proportional",
                   help="branch-length linking across partitions")
    p.add_argument("--iterations", type=int, default=600)
    p.add_argument("--search", action="store_true",
                   help="search topology under the fitted partitioned model "
                        "(summed per-partition analytic SPR scans), then refit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", type=str, default=None)
    _add_device(p, "the fit")
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("modeltest", help="model selection by AIC/AICc/BIC")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str, required=True,
                   help="FASTA/PHYLIP/NEXUS alignment (auto-detected)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--tree", type=str, default=None,
                   help="fixed newick topology (default: stepwise start)")
    p.add_argument("--models", type=str,
                   default="jc,jc+g,k80,hky,hky+g,tn93+g,gtr,gtr+g,gtr+g+i,gtr+r3",
                   help="comma-separated candidates (jc|k80|hky|f81|tn93|gtr|"
                        "empirical with +g/+g+i/+rK suffixes)")
    p.add_argument("--criterion", choices=("aic", "aicc", "bic"), default="bic")
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file for 'empirical' candidates")
    p.add_argument("--seed", type=int, default=0)
    _add_device(p, "the fits")
    p.set_defaults(fn=cmd_modeltest)

    p = sub.add_parser("dnds", help="GY94 codon-model fit (kappa, omega=dN/dS)")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str, required=True,
                   help="in-frame coding nucleotide alignment "
                        "(FASTA/PHYLIP/NEXUS, auto-detected)")
    p.add_argument("--tree", type=str, default=None,
                   help="newick tree (default: stepwise-addition start)")
    p.add_argument("--model", choices=("gy94", "gy94+g"), default="gy94")
    p.add_argument("--freqs", choices=("f61", "f3x4", "f1x4"), default="f3x4",
                   help="codon frequency estimator")
    p.add_argument("--stops", choices=("error", "missing"), default="error",
                   help="how to treat in-frame stop codons")
    p.add_argument("--iterations", type=int, default=600)
    p.add_argument("--search", action="store_true",
                   help="search topology under GY94 (analytic SPR scan at the fitted "
                        "kappa/omega) instead of keeping the start tree, then refit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", type=str, default=None)
    _add_device(p, "the fit")
    p.set_defaults(fn=cmd_dnds)

    p = sub.add_parser("simulate", help="simulate an alignment down a tree (seq-gen equivalent)")
    p.add_argument("--tree", type=str, default=None,
                   help="newick with branch lengths; omitted -> random coalescent "
                        "topology with exponential lengths")
    p.add_argument("--leaves", type=int, default=16,
                   help="taxon count for the generated tree (no --tree)")
    p.add_argument("--sites", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--model", type=str, default="jc",
                   help="jc|gtr|empirical with optional +g / +i suffixes, or gy94 (codon "
                        "simulation; --sites counts codons, output is in-frame "
                        "nucleotide triplets)")
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file for --model empirical")
    p.add_argument("--kappa", type=float, default=2.0,
                   help="GY94 transition/transversion ratio")
    p.add_argument("--omega", type=float, default=0.5, help="GY94 dN/dS ratio")
    p.add_argument("--gtr-rates", type=float, nargs="+", default=None,
                   help="upper-triangle GTR exchangeabilities (default: random, seeded)")
    p.add_argument("--freqs", type=float, nargs="+", default=None)
    p.add_argument("--gamma-shape", type=float, default=0.5)
    p.add_argument("--p-inv", type=float, default=0.2)
    p.add_argument("--categories", type=int, default=4)
    p.add_argument("--default-blen", type=float, default=0.1,
                   help="branch length for generated/length-free trees")
    p.add_argument("--output", type=str, default=None, help="FASTA path (default stdout)")
    p.add_argument("--output-tree", type=str, default=None)
    p.add_argument("--output-ancestors", type=str, default=None,
                   help="also write the true ancestral sequences (FASTA)")
    p.add_argument("--coalescent-ne", type=float, default=None,
                   help="sample the genealogy from a Kingman coalescent with this Ne "
                        "(time units); overrides --tree")
    p.add_argument("--clock-rate", type=float, default=1.0,
                   help="substitutions/site/time-unit for coalescent genealogies "
                        "(branch lengths = rate x waiting time)")
    p.add_argument("--sim-tip-ages", type=str, default=None,
                   help="comma list of sampling ages for a SERIAL coalescent "
                        "(pairs with date --tip-ages)")
    _add_device(p, "the device path of a large simulation (the host walk below "
                   "2^22 node x site cells)")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("search", help="joint topology+sequence search")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--iterations", type=int, default=5000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--restarts", type=int, default=8)
    _add_device(p, "the search")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("asr", help="gradient ASR vs Sankoff oracle")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--lr", type=float, default=1e-2)
    _add_device(p, "the reconstruction")
    p.set_defaults(fn=cmd_asr)

    p = sub.add_parser("search-run", help="checkpointed resumable search")
    _add_common(p)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--no-resume", action="store_true")
    _add_device(p, "the search")
    p.set_defaults(fn=cmd_search_run)

    p = sub.add_parser("bench", help="batched scoring throughput")
    _add_common(p)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=20)
    _add_device(p, "the scoring")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("ml", help="maximum-likelihood tree search")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--rounds", type=int, default=30)
    _add_device(p, "the search")
    p.set_defaults(fn=cmd_ml)

    p = sub.add_parser("nk-bench", help="NK accuracy benchmark")
    _add_common(p)
    p.add_argument("--k-values", type=int, nargs="+", default=[1, 2, 5])
    p.add_argument("--lambdas", type=float, nargs="+", default=[0.0, 0.3, 3.0])
    p.add_argument("--mutation-rate", type=float, default=0.1)
    p.add_argument("--branch-length", type=int, default=1)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--replicates", type=int, default=1,
                   help="independent landscapes per (K, lambda) cell")
    p.add_argument("--plot", type=str, default=None, metavar="OUT.png",
                   help="write the reference-parity errorbar figure "
                        "(needs matplotlib)")
    _add_device(p, "the benchmark")
    p.set_defaults(fn=cmd_nk_bench)

    p = sub.add_parser("bootstrap", help="bootstrap support + consensus")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--replicates", type=int, default=50)
    p.add_argument("--search-rounds", type=int, default=10)
    _add_device(p, "the replicates' climbs")
    p.set_defaults(fn=cmd_bootstrap)

    p = sub.add_parser("treedist", help="Robinson-Foulds distance between two newick trees")
    p.add_argument("trees", nargs=2, help="two newick files")
    p.set_defaults(fn=cmd_treedist)

    p = sub.add_parser("consensus", help="majority-rule consensus of a multi-newick file")
    p.add_argument("trees", help="file with one newick per line")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--output-tree", type=str, default=None)
    p.set_defaults(fn=cmd_consensus)

    p = sub.add_parser("treedraw", help="ASCII rendering of a newick tree")
    p.add_argument("--tree", type=str, required=True)
    p.set_defaults(fn=cmd_treedraw)

    p = sub.add_parser(
        "stats", help="alignment summary: site classes, composition, missing data")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str, required=True)
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser(
        "treeprune", help="extract the induced subtree (+ alignment rows) for a taxa set")
    p.add_argument("--tree", type=str, required=True)
    p.add_argument("--taxa", type=str, required=True, help="comma-separated taxa to keep")
    p.add_argument("--invert", action="store_true",
                   help="drop the listed taxa instead of keeping them")
    p.add_argument("--alignment", type=str, default=None,
                   help="also subset this FASTA to the kept taxa")
    p.add_argument("--output-tree", type=str, default=None)
    p.add_argument("--output-alignment", type=str, default=None)
    p.set_defaults(fn=cmd_treeprune)

    p = sub.add_parser(
        "topotest", help="KH/SH/ELW topology tests of candidate trees on one alignment")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str, required=True,
                   help="FASTA/PHYLIP/NEXUS alignment (auto-detected)")
    p.add_argument("--trees", type=str, required=True, help="multi-newick candidate file")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--model", type=str, default="jc",
                   help="substitution model, fixed at its ML estimates on "
                        "the first tree (jc|k80|hky|f81|tn93|gtr|empirical)")
    p.add_argument("--model-file", type=str, default=None)
    p.add_argument("--replicates", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--site-lnl", type=str, default=None,
                   help="write per-tree per-site log-likelihoods here "
                        "(CONSEL/puzzle site-lnL format) for external "
                        "AU-test tools")
    _add_mesh_flag(p)
    _add_device(p, "the fits and the tests")
    p.set_defaults(fn=cmd_topotest)

    p = sub.add_parser(
        "trait", help="Mk ancestral states for a discrete trait on a fixed tree")
    p.add_argument("--tree", required=True, help="branch-length-bearing newick")
    p.add_argument("--traits", required=True,
                   help="taxon<TAB or ,>state table ('?' = missing)")
    p.add_argument("--output-tree", default=None,
                   help="newick with MAP-state node labels")
    _add_device(p, "the fit")
    p.set_defaults(fn=cmd_trait)

    p = sub.add_parser("concord", help="gene/site concordance factors on a reference tree")
    p.add_argument("--tree", required=True, help="reference newick file")
    p.add_argument("--gene-trees", default=None, help="newick file of per-locus trees (gCF)")
    p.add_argument("--fasta", default=None, help="alignment for sCF")
    p.add_argument("--alphabet", choices=["dna", "protein"], default="dna")
    p.add_argument("--quartets", type=int, default=100,
                   help="random quartets per branch for sCF")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", default=None,
                   help="write the gCF/sCF-labelled newick here")
    p.set_defaults(fn=cmd_concord)

    p = sub.add_parser("bayesfactor", help="stepping-stone marginal likelihoods / Bayes factors")
    p.add_argument("--fasta", required=True)
    p.add_argument("--tree", required=True)
    p.add_argument("--alphabet", choices=["dna", "protein"], default="dna")
    p.add_argument("--models", default="jc,gtr", help="comma list: jc, gtr, jc+g, gtr+g")
    p.add_argument("--rungs", type=int, default=32)
    p.add_argument("--generations", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    _add_mesh_flag(p)
    _add_device(p, "the sampler")
    p.set_defaults(fn=cmd_bayesfactor)

    p = sub.add_parser("date", help="strict-clock LRT + Bayesian node-age dating of a fixed tree")
    p.add_argument("--fasta", required=True)
    p.add_argument("--tree", required=True)
    p.add_argument("--alphabet", choices=["dna", "protein"], default="dna")
    p.add_argument("--model", default="jc",
                   help="jc or a gtr-family string (+g ok); ML-fit, fixed")
    p.add_argument("--generations", type=int, default=4000)
    p.add_argument("--chains", type=int, default=2)
    p.add_argument("--root-prior-mean", type=float, default=0.3,
                   help="Exponential prior mean on the root age (expected substitutions "
                        "per site)")
    p.add_argument("--clock", choices=["strict", "relaxed"], default="strict",
                   help="relaxed = uncorrelated lognormal branch rates")
    p.add_argument("--relaxed-sd", type=float, default=0.3,
                   help="lognormal sd of the relaxed-clock rate prior")
    p.add_argument("--calibrate", action="append", default=None, metavar="TAXA:MIN:MAX",
                   help="uniform age calibration on a clade's MRCA (comma-separated taxa, "
                        "or 'root'); repeatable; switches ages to absolute time + samples "
                        "the clock rate")
    p.add_argument("--tip-ages", default=None, metavar="taxon=age,taxon=age,...",
                   help="heterochronous sampling ages (0 = most recent) for tip dating; all "
                        "taxa required; samples the clock rate")
    p.add_argument("--tree-prior", choices=["uniform", "coalescent"], default="uniform",
                   help="coalescent = Kingman prior on node ages")
    p.add_argument("--ne", type=float, default=None,
                   help="fix the coalescent Ne (default: Gibbs-sample it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", default=None,
                   help="write the posterior-mean ultrametric newick here")
    _add_device(p, "the fits and the sampler")
    p.set_defaults(fn=cmd_date)

    p = sub.add_parser("mcmc", help="Bayesian MCMC tree sampling (Metropolis-coupled chains)")
    p.add_argument("--fasta", required=True)
    p.add_argument("--alphabet", choices=["dna", "protein"], default="dna")
    p.add_argument("--model", default="jc",
                   help="jc (default) or a gtr-family string (+g ok); non-jc models are "
                        "ML-fit once and held fixed (empirical Bayes)")
    p.add_argument("--generations", type=int, default=10_000)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--heat", type=float, default=0.1)
    p.add_argument("--sample-every", type=int, default=20)
    p.add_argument("--burnin", type=float, default=0.25)
    p.add_argument("--branch-moves", type=int, default=2,
                   help="branch-length moves per generation")
    p.add_argument("--proposal", choices=["informed", "nni"], default="informed")
    p.add_argument("--informed-power", type=float, default=0.1,
                   help="weight exponent p of the informed proposal (neighbour weight "
                        "posterior^(p*beta))")
    p.add_argument("--full-bayes", action="store_true",
                   help="sample GTR exchangeabilities + frequencies in the chain (flat "
                        "Dirichlet priors) instead of fixing them at the ML fit")
    p.add_argument("--brlen-prior-mean", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", default=None, help="write the consensus newick here")
    p.add_argument("--samples-out", default=None,
                   help="write sampled trees (newick, one per line) here")
    p.add_argument("--trace-out", default=None,
                   help="Tracer-compatible TSV of scalar traces (lnL, tree length, model "
                        "simplices)")
    p.add_argument("--progress-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable state dir (bit-identical resume; keep --generations "
                        "constant across legs)")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--stop-after", type=int, default=None,
                   help="run at most this many generations this invocation, then "
                        "checkpoint and exit")
    _add_mesh_flag(p)
    _add_device(p, "the sampler")
    p.set_defaults(fn=cmd_mcmc)
    return parser


def main(argv: list[str] | None = None) -> None:
    # Float32 products stay full float32 on the card (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(argv)
    if args.fn not in (cmd_infer, cmd_topotest, cmd_mcmc, cmd_bayesfactor):
        refuse_world(args.command)
    args.fn(args)


if __name__ == "__main__":
    main()
