"""Command-line interface: ``python -m trex_tpu_torch.cli <command>``.

score       Exact Sankoff scoring + ancestral reconstruction of a generated
            balanced mutation tree, or (``--alignment``) the Fitch score and
            one optimal labeling of a given or stepwise-addition tree.
            With ``--criterion ml``: ML branch lengths (or a fitted
            ``--model``), marginal or joint ancestors, site rates.
infer       File-based parsimony or ML tree inference: FASTA/PHYLIP/NEXUS
            in, stepwise-addition, random, balanced or differentiable
            (``--start diff``) start, SPR-scan (default), NNI, SPR or TBR
            hill climb (parsimony: also the ratchet, constraints, outgroup
            rooting, SPR-decay and bootstrap supports; ML: a fitted
            ``--model`` with +G/+I/+R rate mixtures and model <-> tree
            ``--model-rounds``, the iterated search (``--ratchet``),
            constraints, bootstrap, aLRT / SH-aLRT (``--alrt``) and
            ultrafast bootstrap (``--ufboot``) supports), or (``--criterion
            distance``) an NJ/UPGMA tree with bootstrap supports; newick
            and score out as one JSON line. ``--start nj|upgma`` starts
            either criterion from the distance tree.
partition   Partitioned ML fit (a model per partition, shared lengths with
            rate multipliers), with ``--search`` a climb under it.
modeltest   Model selection by AIC/AICc/BIC on a fixed tree.
dnds        GY94 codon-model fit (kappa, omega = dN/dS, +G) on a coding
            alignment, on a given or stepwise tree, with ``--search`` an
            SPR-scan climb under the fitted 61-state model.
simulate    Simulate an alignment down a given, random or coalescent tree
            under JC/GTR/empirical (+G, +I) or GY94 codons (seq-gen
            equivalent); large simulations sample on the card.
search      Multi-restart joint topology + sequence search on a generated
            mutation tree, against exact Sankoff on the true tree.
asr         Gradient ancestral reconstruction against exact Sankoff.
search-run  The joint search, checkpointed and resumable.
bench       Batched candidate-scoring throughput on random trees (the Fitch
            kernel for Hamming with <= 32 states, the Sankoff kernel above).
ml          ML climb (JC69, SPR neighbourhoods) on a generated alignment.
nk-bench    Sankoff vs plain and landscape-aware gradient ASR on trees
            evolved over NK fitness landscapes.
bootstrap   Parsimony bootstrap supports and their majority-rule consensus
            on a generated balanced mutation tree.
trait       Mk-model marginal ancestral states of a discrete trait on a
            given tree with branch lengths.
treedist    Robinson-Foulds (and, with lengths, branch-score, weighted RF
            and path-difference) distances between two newick trees.
consensus   Majority-rule consensus of a multi-newick file.
treedraw    ASCII rendering of a newick tree.
stats       Alignment summary: site classes, composition, missing data.
treeprune   The induced subtree (and alignment rows) of a taxa subset.
topotest    KH / SH / BP / ELW / AU tests of candidate trees on one
            alignment, each at its own Newton-fitted lengths.
concord     Gene and site concordance factors of a reference tree.
mcmc        Bayesian tree sampling by Metropolis-coupled chains (MC^3):
            split posteriors, consensus, ASDSF, ESS; a fixed (ML-fitted)
            or sampled (``--full-bayes``) GTR model.
bayesfactor Stepping-stone log marginal likelihoods of models on a tree.
date        The strict-clock LRT and Bayesian node ages of a tree (strict
            or relaxed clock, calibrations, tip dates, coalescent prior).

Each prints the same JSON keys as ``python -m trex_tpu.cli <command>``, and
``score``/``infer`` the same trees and scores (``infer --start diff``,
``--ratchet``, ``--bootstrap``, the samplers' chains, ``simulate``'s
substitutions and the generated-data commands draw from the port's own
generators). The commands that compute on a device run
on the card (``--device cuda``, default) or the CPU; the tree-file tools
(``treedist``, ``consensus``, ``treedraw``, ``stats``, ``treeprune``,
``concord``) are host numpy.
"""

from trex_tpu_torch.cli.parser import build_parser, main

__all__ = ["build_parser", "main"]
