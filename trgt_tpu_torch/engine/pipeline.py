"""The port's batch pipeline: `trgt_tpu.engine.pipeline.BatchPipeline`
with every device path re-routed to PyTorch.

The per-locus decision logic stays in the JAX package's JAX-free modules
(`engine/workflow.py`, `genotype/`, `hmm/`); this subclass overrides only
the methods that would import JAX or race a remote device:

  _start_link_probe   no link probe (there is no remote link)
  _hedged             a direct call of the host twin (reached only with
                      `device=None`); no race, no latch
  _align_misses       span stage: the same certified windows
                      (`span_window`), sent to the port's flank kernel;
                      certificate failures go through the same kernel on
                      the full text
  _stage_genotype     unchanged but for where MAX_OPS comes from and
                      the cluster edit distances, which run on the host
                      twin (the edit-distance kernel is not ported yet)
  _consensus_aligner  the host aligner (consensus repair is not ported)
  _viterbi            annotate stage: the port's Viterbi kernel

With `device=None` (`--device host`) every stage runs the JAX package's
host twins.
"""

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from trgt_tpu.engine.pipeline import BatchPipeline
from trgt_tpu.engine.workflow import LocusResult
from trgt_tpu.genotype import genotype_cluster, genotype_flank, genotype_size
from trgt_tpu.kernels import span_window
from trgt_tpu.utils import Genotyper

from ..kernels.semiglobal import flank_align_batch_multi
from ..kernels.viterbi import viterbi_batch_multi

log = logging.getLogger("trgt")

# cluster genotyper: exact edit distance only for pairs with
# len_a * len_b <= MAX_OPS, the |length difference| bound above
# (trgt_tpu/kernels/editdist.py:23, which imports JAX)
MAX_OPS = 10000


class TorchBatchPipeline(BatchPipeline):
    def __init__(self, params, device: Optional[torch.device],
                 batch_size: int = 64, num_threads: int = 1,
                 bam_factory=None):
        super().__init__(params, batch_size=batch_size,
                         use_device=device is not None,
                         num_threads=num_threads, bam_factory=bam_factory)
        self.device = device
        self._routing_logged = False

    def _start_link_probe(self):
        return None

    def _hedged(self, stage, device_fn, host_fn, deadline_s,
                host_est_s=None):
        # only the base class's host paths (device None) get here: every
        # device path is overridden below, and device_fn would import JAX
        if self.use_device:
            raise RuntimeError(f"{stage}: no device path in the port")
        return host_fn()

    # ---- stage 1: span location ----
    def _align_misses(self, patterns, texts, sc):
        if self.device is None:
            return super()._align_misses(patterns, texts, sc)
        plans = [span_window.plan_windows(p, t, sc.mism_scr, sc.gapo_scr,
                                          sc.gape_scr)
                 for p, t in zip(patterns, texts)]
        sub_patterns, sub_texts, _bands, owners = span_window.expand(
            plans, patterns, texts)
        sub_results = flank_align_batch_multi(
            sub_patterns, sub_texts, sc.mism_scr, sc.gapo_scr, sc.gape_scr,
            self.device)
        out, redo = span_window.reduce_and_certify(
            plans, owners, sub_results, len(texts), sc.mism_scr,
            sc.gapo_scr, sc.gape_scr)
        if redo:
            log.debug("span windows: %d/%d certificate failures "
                      "recomputed on the full text", len(redo), len(texts))
            full = flank_align_batch_multi(
                [patterns[mi] for mi in redo], [texts[mi] for mi in redo],
                sc.mism_scr, sc.gapo_scr, sc.gape_scr, self.device)
            for mi, res in zip(redo, full):
                out[mi] = res
        return out

    # ---- stage 3: genotyping ----
    def _stage_genotype(self, states):
        # BatchPipeline._stage_genotype with MAX_OPS from this module and
        # the cluster edit distances on the host twin (the edit-distance
        # kernel is not ported yet)
        cluster_states = []
        all_pairs = []
        for st in states:
            if st.done:
                continue
            if not st.reads:
                st.result = LocusResult.empty()
                st.done = True
                continue
            st.trs = [read.bases[s[0]:s[1]].decode()
                      for read, s in zip(st.reads, st.spans)]
            if st.locus.genotyper == Genotyper.CLUSTER:
                uniq: Dict[bytes, int] = {}
                uidx = np.array([uniq.setdefault(t.encode(), len(uniq))
                                 for t in st.trs], dtype=np.int64)
                useqs = list(uniq)
                ulens = np.array([len(s) for s in useqs], dtype=np.int64)
                U = len(useqs)
                ed_u = np.abs(ulens[:, None] - ulens[None, :]) \
                    .astype(np.float64)
                ei_parts, ej_parts = [], []
                for i in range(U - 1):
                    js = np.nonzero(
                        ulens[i] * ulens[i + 1:] <= MAX_OPS)[0]
                    if js.size:
                        ei_parts.append(np.full(js.size, i,
                                                dtype=np.int64))
                        ej_parts.append(js.astype(np.int64) + i + 1)
                if ei_parts:
                    ei = np.concatenate(ei_parts)
                    ej = np.concatenate(ej_parts)
                else:
                    ei = ej = np.empty(0, dtype=np.int64)
                start = len(all_pairs)
                all_pairs.extend((useqs[a], useqs[b])
                                 for a, b in zip(ei, ej))
                cluster_states.append((st, ed_u, uidx, ei, ej, start))

        pair_eds: List[int] = []
        if all_pairs:
            from trgt_tpu.kernels.align_host import edit_distance
            pair_eds = [edit_distance(a, b) for a, b in all_pairs]

        cluster_lookup = {}
        for st, ed_u, uidx, ei, ej, start in cluster_states:
            if ei.size:
                eds = np.asarray(pair_eds[start:start + ei.size],
                                 dtype=np.float64)
                ed_u[ei, ej] = eds
                ed_u[ej, ei] = eds
            cluster_lookup[id(st)] = (ed_u, uidx)

        aligner = self._consensus_aligner()
        for st in states:
            if st.done:
                continue
            if st.locus.genotyper == Genotyper.SIZE:
                gt, alleles, classification = genotype_size.genotype(
                    st.locus.ploidy, st.trs, aligner=aligner)
            else:
                gt, alleles, classification = genotype_cluster.genotype(
                    st.locus.ploidy, st.trs,
                    pair_dists=cluster_lookup.get(id(st)),
                    aligner=aligner)
            # SNP-flank rescue (tr.rs:70-75)
            if len(gt) == 2 and abs(gt[0].size - gt[1].size) <= 10:
                snp_result = genotype_flank.genotype(st.reads, st.trs,
                                                     aligner=aligner)
                if snp_result is not None:
                    gt, alleles, classification = snp_result
            st.gt = gt
            st.allele_seqs = alleles
            st.classification = classification

    def _consensus_aligner(self):
        """Host consensus aligner on every device: the consensus-repair
        kernel (`_e2e_scan`) and the edit-distance kernel are not ported
        yet, so the genotype stage runs its host twins by design."""
        from trgt_tpu.genotype import consensus
        if self.use_device and not self._routing_logged:
            log.info("genotype stage: consensus repair and cluster edit "
                     "distances run on the host twins (not ported to "
                     "%s yet)", self.device)
            self._routing_logged = True
        if self.num_threads <= 1:
            return consensus.align_batch
        return self._host_consensus_aligner()

    # ---- stages 2a / 4: Viterbi labelings ----
    def _viterbi(self, hmms, queries):
        if self.device is None:
            return super()._viterbi(hmms, queries)
        return viterbi_batch_multi(hmms, queries, self.device)
