"""The port's planning path: the paper's offline schedulers (BNA, DMA,
DMA-SRT/RT, the Algorithm 5 order, G-DM / G-DM-RT, O(m)Alg, backfill) on
PyTorch, with the BNA decomposition and the merge on hand-written CUDA
kernels, through the python plan path or the pipeline (``core/pipeline.py``),
the online protocol over it (``SchedulerSession``, ``simulate_online``,
``plan_online``, the streaming harness), and the paper's workload and
analytical constructions (``workload_stats``, Theorem 1's
``fsp_to_coflow_job``, Lemma 2's ``gap_instance``).  Each module mirrors
its namesake in ``repro.core``."""

from .backend import (bna_pieces_many, cache_stats, clear_caches,
                      compute_alphas, fixup_pieces, group_block,
                      grouping_prefix, no_caches, prefetch_bna,
                      prefetch_plan, resolve_plan_backend)
from .backfill import BackfillResult, backfill
from .baseline import om_alg
from .bna import bna, verify_bna_schedule
from .convert import (instance_from_arrays, instance_to_arrays,
                      transcript_to_arrays)
from .dma import dma, isolated_job_unit
from .dma_srt import dma_rt, dma_srt, path_subjobs, srt_start_times
from .engine import (PlanResult, available_schedulers, make_scheduler, plan,
                     plan_online, register_scheduler, scheduler_options)
from .fsp_reduction import fsp_to_coflow_job
from .gap_instance import (gap_bounds, gap_hand_schedule, gap_instance,
                           gap_optimal_schedule_length)
from .gdm import GammaEpoch, gdm, geometric_bucket, group_jobs
from .matching import bna_many, bucket_width
from .online import OnlineResult, simulate_online
from .session import (AdmissionPolicy, Frontier, SchedulerSession,
                      SessionSnapshot, SessionStats)
from .stream import (StreamDriver, StreamResult, arrival_times, run_stream,
                     stream_jobs)
from .ordering import OrderResult, cached_job_order, job_order
from .result import CompositeSchedule, Transcript, twct
from .simulator import verify_schedule, verify_transcript
from .timeline import FinalSchedule, UnitSchedule, merge_and_fix
from .traces import (PAPER_STATS, build_jobs, dag_edges, fb_like_coflows,
                     paper_workload, poisson_releases, port_skew,
                     sample_coflows, sample_sizes, sample_width, theta0,
                     workload_stats)
from .types import (Coflow, Instance, Job, aggregate_size, coflow_layers,
                    critical_path_size, effective_size, is_rooted_tree,
                    topological_order)

__all__ = [name for name in dir() if not name.startswith("_")]
