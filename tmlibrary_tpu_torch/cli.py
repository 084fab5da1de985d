"""Command-line interface of the port.

Counterpart: ``tmlibrary_tpu/cli.py`` (``tmx``), with the verbs of the
steps the port has, the same argument names and the same JSON output::

    python -m tmlibrary_tpu_torch.cli create --root DIR --name NAME
    python -m tmlibrary_tpu_torch.cli workflow submit --root DIR [--description wf.yaml]
                                                      [--resume] [--device cuda] [--qc|--no-qc]
    python -m tmlibrary_tpu_torch.cli workflow resume --root DIR ...
    python -m tmlibrary_tpu_torch.cli workflow status|cleanup --root DIR
    python -m tmlibrary_tpu_torch.cli workflow template --root DIR [--type canonical|multiplexing]
    python -m tmlibrary_tpu_torch.cli <step> init|run|collect|info|cleanup|args --root DIR ...
    python -m tmlibrary_tpu_torch.cli project create|add-module|remove-module|add-channel|show
                                              --dir DIR ... | modules | check --pipe P
    python -m tmlibrary_tpu_torch.cli export --root DIR --out PATH
                                             (--objects NAME [--format csv|parquet|geojson]
                                              [--join-features COLS] [--simplify TOL]
                                             | --images CHANNEL [--cycle C] [--correct]
                                               [--align] [--ome]
                                             | --ngff [--ngff-levels N] [--ngff-labels NAMES])
    python -m tmlibrary_tpu_torch.cli inspect [--json] FILE_OR_DIR ...
    python -m tmlibrary_tpu_torch.cli log --root DIR [--tail N] [--step S [--job N]]
    python -m tmlibrary_tpu_torch.cli qc --root DIR [--json] [--reference qc.json]
                                         [--profile-kind run|model]
    python -m tmlibrary_tpu_torch.cli weights list [--dir DIR] | digest SPEC [--json]
    python -m tmlibrary_tpu_torch.cli query --root DIR --tool T --objects NAME
                                            [--payload JSON | --payload-file F]
                                            [--index auto|ivf|brute] [--no-cache] [--device cuda]
    python -m tmlibrary_tpu_torch.cli index build|list --root DIR --objects NAME ...
    python -m tmlibrary_tpu_torch.cli tool submit|list|status|run-request|available ...

``<step>`` is ``metaconfig``, ``imextract``, ``corilla``, ``align``,
``illuminati`` or ``jterator``; the installed console script is
``tmx-torch``.  ``workflow submit`` reads ``--description`` or the
store's ``workflow/workflow.yaml`` (YAML through
:mod:`tmlibrary_tpu_torch.yamlio`), which ``workflow template`` writes;
``workflow cleanup`` removes every step's outputs and batch plans, the
mapobject registrations and the run ledger, ``<step> cleanup`` one
step's.  ``project`` manages a jterator project
(:mod:`tmlibrary_tpu_torch.jterator.project`); ``export`` writes the
feature table (Parquet through the port's codec, or CSV), the polygons
as GeoJSON, one channel's site images as uint16 TIFFs or OME-TIFFs, or
the whole plate as OME-NGFF (:mod:`tmlibrary_tpu_torch.ngff`), as the
reference's verbs do; ``--illumstats`` (HDF5) raises
:class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming ROADMAP
item 12b.  ``create`` makes the placeholder store a canonical run starts
from (metaconfig writes its manifest).  ``inspect`` prints a microscope
file's dimensions and channel names from the port's readers (the
Bio-Formats ``showinf`` role), or for a source directory the ingest
metaconfig would make of it (its handler through
:func:`~tmlibrary_tpu_torch.workflow.steps.vendors.resolve_sidecars`),
with the JAX package's keys and exit codes.  The step verbs and
``workflow submit``/``resume`` take ``--device``, ``cuda`` unless ``cpu``
is asked for; without a card, ``cuda`` raises.  ``--qc``/``--no-qc`` set
``TMX_QC`` for the run, as the reference's do.  ``qc`` reports a run's QC
profile (``workflow/qc*.json``, else its ledger events) and exits with
the drift verdict's code against ``--reference`` (else the
``TMX_QC_BASELINE`` or, for ``--profile-kind model``,
``TMX_QC_DL_BASELINE`` file): 0 ok, 1 drift, 2 stale, 3 no reference;
unlike the reference it reads no baseline from ``tuning/``.  ``weights``
lists the checkpoints of the weights directory or digests a spec.
``query`` answers one analytics query over the feature store (cached by
the store's content digest), ``index`` builds or lists the IVF kNN
indexes, ``tool`` submits and inspects tool requests (``--background``
runs one as a detached process that keeps the request's device); all
three take ``--device``, ``cuda`` by default.

``workflow submit`` under ``torchrun --nproc-per-node N`` runs on N
ranks, one card each (NCCL; gloo with ``--device cpu``): the process
group comes from ``torchrun``'s environment
(:func:`~tmlibrary_tpu_torch.parallel.distributed.initialize`), rank 0
plans, writes and prints, and corilla, illuminati and jterator shard
their work over the ranks their ``n_devices`` allows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from pathlib import Path

from tmlibrary_tpu_torch.models.experiment import Experiment
from tmlibrary_tpu_torch.models.mapobject import MapobjectTypeRegistry
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.resilience import ResilienceConfig
from tmlibrary_tpu_torch.workflow.engine import RunLedger, Workflow, WorkflowDescription
from tmlibrary_tpu_torch.workflow.registry import get_step, list_steps


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--root", required=True, help="experiment store directory")
    parser.add_argument("-v", "--verbosity", action="count", default=0)
    parser.add_argument("--device", default="cuda",
                        help="device the work runs on: cuda (default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tmx-torch", description="microscopy image analysis on the card (PyTorch port)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="create an empty experiment store")
    p_create.add_argument("--root", required=True, help="experiment store directory")
    p_create.add_argument("-v", "--verbosity", action="count", default=0)
    p_create.add_argument("--name", required=True)

    p_inspect = sub.add_parser(
        "inspect",
        help="print a microscope file's dimensions/channels (the Bio-Formats 'showinf' "
             "role, on the port's readers)")
    p_inspect.add_argument("files", nargs="+")
    p_inspect.add_argument("--json", action="store_true", dest="as_json",
                           help="one JSON object per file")

    p_log = sub.add_parser("log", help="show the run ledger or captured step logs")
    _add_common(p_log)
    p_log.add_argument("--tail", type=int, default=20)
    p_log.add_argument("--step", default=None, help="print a step's captured log file instead")
    p_log.add_argument("--job", type=int, default=None,
                       help="batch index (with --step); omit for the whole-step run log")

    p_export = sub.add_parser(
        "export", help="export feature tables, polygons, site images or the whole plate")
    _add_common(p_export)
    p_export.add_argument("--objects", default=None, help="object type name")
    p_export.add_argument(
        "--illumstats", type=int, default=None, metavar="CHANNEL",
        help="illumination statistics as HDF5: not ported (no h5py on the target machine)")
    p_export.add_argument("--cycle", type=int, default=0,
                          help="acquisition cycle for --illumstats/--images (default 0)")
    p_export.add_argument(
        "--images", type=int, default=None, metavar="CHANNEL",
        help="instead of a feature table, write this channel's site images as uint16 TIFFs "
             "into --out (a directory), named with the canonical <well>_s<site>_... pattern")
    p_export.add_argument("--correct", action="store_true",
                          help="--images only: apply illumination correction (corilla stats)")
    p_export.add_argument("--align", action="store_true",
                          help="--images only: apply cycle alignment shifts + intersection crop")
    p_export.add_argument("--ome", action="store_true",
                          help="--images only: write OME-TIFFs (OME-XML in ImageDescription) "
                               "instead of bare TIFFs")
    p_export.add_argument(
        "--ngff", action="store_true",
        help="write the whole experiment as an OME-NGFF (OME-Zarr v0.4) HCS plate into --out "
             "(a directory, conventionally *.zarr); it re-ingests through the ngff "
             "metaconfig handler")
    p_export.add_argument("--ngff-levels", type=int, default=3, metavar="N",
                          help="--ngff only: number of 2x multiscale levels (default 3)")
    p_export.add_argument("--ngff-labels", default=None, metavar="NAME[,NAME...]",
                          help="--ngff only: also export these segmentation stacks as NGFF "
                               "image-label multiscales under each field's labels/ group")
    p_export.add_argument("--out", required=True, help="output file path")
    p_export.add_argument(
        "--format", choices=("csv", "parquet", "geojson"), default=None,
        help="inferred from --out suffix when omitted; geojson exports the traced object "
             "polygons (run jterator with --as-polygons)")
    p_export.add_argument(
        "--join-features", default=None, metavar="COL[,COL...]",
        help="geojson only: join these measurement columns onto each polygon's properties "
             "by (site, label)")
    p_export.add_argument(
        "--simplify", type=float, default=0.0, metavar="TOL",
        help="geojson only: Douglas-Peucker-simplify polygon rings to this "
             "perpendicular-distance tolerance in pixels")

    p_wf = sub.add_parser("workflow", help="full workflow orchestration")
    wf_sub = p_wf.add_subparsers(dest="verb", required=True)
    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("--description",
                        help="workflow description, YAML (default: the store's "
                             "workflow/workflow.yaml)")
    shared.add_argument("--pipeline-depth", type=int, default=None, metavar="N",
                        help="in-flight device batches for the pipelined executor "
                             "(default: 8 on the card, 2 on the CPU)")
    shared.add_argument("--max-batch-failures", type=float, default=None, metavar="X",
                        help="per-step quarantine budget before the step fails: < 1 a "
                             "fraction of the step's batches, >= 1 a count (default 0.5)")
    shared.add_argument("--retry-attempts", type=int, default=None, metavar="N",
                        help="total tries per batch for transient faults (1 = no retry)")
    shared.add_argument("--retry-delay", type=float, default=None, metavar="SECONDS",
                        help="first backoff delay; doubles per retry, with jitter")
    shared.add_argument("--qc", action=argparse.BooleanOptionalAction, default=None,
                        help="collect data-quality evidence for this run: per-site image "
                             "statistics, NaN and outlier guards, feature sketches and the "
                             "DL segmenters' model streams -> workflow/qc.json and qc_* "
                             "ledger events (default: TMX_QC / TM_QC, off)")
    p_submit = wf_sub.add_parser("submit", help="run the workflow", parents=[shared])
    _add_common(p_submit)
    p_submit.add_argument("--resume", action="store_true",
                          help="skip work completed in a previous run")
    p_resume = wf_sub.add_parser("resume", help="shorthand for submit --resume",
                                 parents=[shared])
    _add_common(p_resume)
    p_resume.set_defaults(resume=True)
    p_status = wf_sub.add_parser("status", help="per-step progress")
    _add_common(p_status)
    p_clean = wf_sub.add_parser(
        "cleanup", help="remove every step's outputs, batch plans, the mapobject "
                        "registrations and the run ledger")
    _add_common(p_clean)
    p_tmpl = wf_sub.add_parser("template", help="write a typed skeleton workflow.yaml")
    _add_common(p_tmpl)
    p_tmpl.add_argument("--type", dest="wf_type", choices=("canonical", "multiplexing"),
                        default="canonical", help="workflow type (multiplexing adds align)")

    p_qc = sub.add_parser(
        "qc", help="data-quality report of a run and its drift verdict against a reference "
                   "profile; exit codes: 0 ok, 1 drift, 2 stale reference, 3 no reference")
    _add_common(p_qc)
    p_qc.add_argument("--json", action="store_true", dest="as_json",
                      help="print the profile and the verdict as JSON")
    p_qc.add_argument("--worst", type=int, default=5, metavar="N",
                      help="worst-focus and flagged sites to list")
    p_qc.add_argument("--reference", default=None, metavar="PATH",
                      help="reference qc.json (default: TMX_QC_BASELINE, or "
                           "TMX_QC_DL_BASELINE with --profile-kind model)")
    p_qc.add_argument("--threshold", type=float, default=0.25,
                      help="allowed median shift as a fraction of the reference spread")
    p_qc.add_argument("--stale-hours", type=float, default=None, dest="stale_hours",
                      help="reference staleness budget in hours (default TMX_QC_STALE_HOURS, "
                           "0 = no check)")
    p_qc.add_argument("--profile-kind", choices=("run", "model"), default="run",
                      dest="profile_kind",
                      help="'run': acquisition and feature drift; 'model': only the "
                           "__model__ streams of the DL segmenters")

    p_weights = sub.add_parser("weights", help="DL checkpoints: list the weights directory "
                                               "or digest a weight spec")
    w_sub = p_weights.add_subparsers(dest="verb", required=True)
    p_wl = w_sub.add_parser("list", help="checkpoints of the weights directory with their "
                                         "content digests")
    p_wl.add_argument("--dir", default=None, help="weights directory (default TMX_WEIGHTS_DIR)")
    p_wl.add_argument("--json", action="store_true", dest="as_json")
    p_wd = w_sub.add_parser("digest", help="resolve a weight spec and print its content digest")
    p_wd.add_argument("spec", help="checkpoint name, .npz path, or "
                                   "seed:N[:base=C][:depth=D][:in=N]")
    p_wd.add_argument("--json", action="store_true", dest="as_json")

    p_query = sub.add_parser(
        "query", help="one-shot analytics query over an experiment's feature store "
                      "(knn/pca/embedding/spatial/clustering/heatmap/classification; results "
                      "are cached by feature-store digest)")
    _add_common(p_query)
    p_query.add_argument("--tool", required=True, help="tool name (see 'tool available')")
    p_query.add_argument("--objects", default=None, metavar="NAME",
                         help="objects_name shorthand (else put objects_name in the payload)")
    p_query.add_argument("--payload", default=None, help="tool payload as inline JSON")
    p_query.add_argument("--payload-file", default=None, help="tool payload from a JSON file")
    p_query.add_argument("--index", default=None, choices=["auto", "ivf", "brute"],
                         help="kNN index routing (knn/embedding/clustering/classification), "
                              "merged into the payload")
    p_query.add_argument("--no-cache", action="store_true",
                         help="recompute even when a digest-keyed cached result exists")

    p_index = sub.add_parser("index", help="IVF kNN index over an experiment's feature store: "
                                           "build or list the persisted indexes")
    index_sub = p_index.add_subparsers(dest="verb", required=True)
    p_ibuild = index_sub.add_parser("build", help="build (or reuse) the index for one "
                                                  "objects_name; prints its manifest as JSON")
    _add_common(p_ibuild)
    p_ibuild.add_argument("--objects", required=True, metavar="NAME")
    p_ibuild.add_argument("--features", default=None,
                          help="comma list of feature columns (default: all)")
    p_ibuild.add_argument("--cells", type=int, default=None,
                          help="cell count (default: 4*sqrt(N))")
    p_ibuild.add_argument("--rebuild", action="store_true",
                          help="rebuild even when the persisted index matches the store digest")
    p_ilist = index_sub.add_parser("list", help="persisted indexes of one objects_name with "
                                                "their staleness against the store digest")
    _add_common(p_ilist)
    p_ilist.add_argument("--objects", required=True, metavar="NAME")

    p_tool = sub.add_parser("tool", help="analysis tools over the feature store")
    tool_sub = p_tool.add_subparsers(dest="verb", required=True)
    p_tsubmit = tool_sub.add_parser("submit", help="run one tool request")
    _add_common(p_tsubmit)
    p_tsubmit.add_argument("--name", required=True, help="tool name (see 'tool available')")
    p_tsubmit.add_argument("--payload", default="{}", help="request payload as inline JSON")
    p_tsubmit.add_argument("--payload-file", default=None,
                           help="request payload from a JSON file")
    p_tsubmit.add_argument("--background", action="store_true",
                           help="run the request as a detached process and print its id; "
                                "poll with 'tool status'")
    p_tlist = tool_sub.add_parser("list", help="tool requests with their lifecycle state")
    _add_common(p_tlist)
    p_tstatus = tool_sub.add_parser("status", help="one request's state")
    _add_common(p_tstatus)
    p_tstatus.add_argument("--request", required=True)
    p_trun = tool_sub.add_parser("run-request", help="run a submitted request (the body of "
                                                     "--background)")
    _add_common(p_trun)
    p_trun.add_argument("--request", required=True)
    tool_sub.add_parser("available", help="registered tool names")

    p_proj = sub.add_parser("project", help="manage a jterator pipeline project")
    proj_sub = p_proj.add_subparsers(dest="verb", required=True)
    p_pcreate = proj_sub.add_parser("create", help="create a skeleton project")
    p_pcreate.add_argument("--dir", required=True, help="project directory")
    p_pcreate.add_argument("--description", default="")
    p_padd = proj_sub.add_parser("add-module", help="append a module instance")
    p_padd.add_argument("--dir", required=True)
    p_padd.add_argument("--module", required=True)
    p_padd.add_argument("--instance", default=None)
    p_premove = proj_sub.add_parser("remove-module", help="remove a module instance")
    p_premove.add_argument("--dir", required=True)
    p_premove.add_argument("--instance", required=True)
    p_pchan = proj_sub.add_parser("add-channel", help="declare an input channel")
    p_pchan.add_argument("--dir", required=True)
    p_pchan.add_argument("--name", required=True)
    p_pchan.add_argument("--no-correct", action="store_true")
    p_pchan.add_argument("--align", action="store_true")
    p_pshow = proj_sub.add_parser("show", help="modules in pipeline order")
    p_pshow.add_argument("--dir", required=True)
    proj_sub.add_parser("modules", help="registered module names")
    p_pcheck = proj_sub.add_parser(
        "check", help="validate a pipeline without running it: dataflow, module names, "
                      "parameter names")
    p_pcheck.add_argument("--pipe", required=True, help="path to .pipe.yaml")

    for name in list_steps():
        step_cls = get_step(name)
        p_step = sub.add_parser(name, help=f"{name} step")
        verb_sub = p_step.add_subparsers(dest="verb", required=True)
        p_init = verb_sub.add_parser("init", help="plan batches")
        _add_common(p_init)
        step_cls.batch_args.add_to_parser(p_init)
        p_run = verb_sub.add_parser("run", help="run one batch (or all)")
        _add_common(p_run)
        p_run.add_argument("--job", type=int, default=None, help="batch index (default: all)")
        p_collect = verb_sub.add_parser("collect", help="merge phase")
        _add_common(p_collect)
        p_info = verb_sub.add_parser("info", help="planned batches")
        _add_common(p_info)
        p_clean = verb_sub.add_parser("cleanup", help="delete this step's previous outputs")
        _add_common(p_clean)
        p_args = verb_sub.add_parser("args", help="argument schema as JSON")
        p_args.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return parser


def _open_store(args) -> ExperimentStore:
    return ExperimentStore.open(Path(args.root))


def cmd_create(args) -> int:
    root = Path(args.root)
    if (root / ExperimentStore.MANIFEST).exists():
        print(f"error: store already exists at {root}", file=sys.stderr)
        return 1
    placeholder = Experiment(name=args.name, plates=[], channels=[], site_height=1,
                             site_width=1)
    ExperimentStore.create(root, placeholder)
    print(f"created experiment '{args.name}' at {root}")
    return 0


def cmd_workflow(args) -> int:
    store = _open_store(args)
    if args.verb == "status":
        status = RunLedger(store.workflow_dir / "ledger.jsonl").status()
        if not status:
            print("no workflow runs recorded")
            return 0
        for step, entry in status.items():
            done, total = entry["batches_done"], entry["n_batches"]
            frac = f"{done}/{total}" if total is not None else str(done)
            line = f"{step:12s} {entry['state']:8s} batches {frac} ({entry['elapsed']:.1f}s)"
            if entry.get("quarantined"):
                line += f" quarantined: {sorted(entry['quarantined'])}"
            if entry.get("error"):
                line += f" error: {entry['error']}"
            print(line)
            ps = entry.get("pipeline_stats")
            if ps:
                phases = " ".join(f"{ph}={v['total_s']:.2f}s"
                                  for ph, v in ps.get("phases", {}).items())
                print(f"{'':12s} pipeline depth {ps.get('depth')} ({ps.get('source')}) "
                      f"over {ps.get('n_batches')} batches: {phases}")
            for clamp in entry.get("depth_clamps", []):
                print(f"{'':12s} depth clamped {clamp.get('from')} -> {clamp.get('to')} "
                      "(resource exhausted)")
            buckets = entry.get("buckets")
            if buckets:
                routed = " ".join(f"cap{c}x{n}" for c, n in sorted(
                    buckets["routed"].items(), key=lambda kv: int(kv[0])))
                line = f"{'':12s} buckets: {routed}"
                if buckets.get("occupancy_n"):
                    occ = buckets["occupancy_sum"] / buckets["occupancy_n"]
                    line += f" slot occupancy {occ:.1%}"
                if buckets.get("escalations"):
                    line += f" escalations {buckets['escalations']}"
                print(line)
        return 0
    if args.verb == "cleanup":
        for name in list_steps():
            _cleanup_step(get_step(name)(store, device=args.device))
        # the registry would otherwise advertise object types whose
        # label and feature files were just removed
        registry = MapobjectTypeRegistry(store.root)
        for name in registry.names():
            registry.delete(name)
        (store.workflow_dir / "ledger.jsonl").unlink(missing_ok=True)
        print("removed all step outputs, batch plans, mapobject registrations and the run "
              "ledger")
        return 0
    if args.verb == "template":
        out = store.workflow_dir / "workflow.yaml"
        if out.exists():
            print(f"error: {out} already exists", file=sys.stderr)
            return 1
        WorkflowDescription.for_type(args.wf_type).save(out)
        print(f"wrote {args.wf_type} workflow template to {out} — fill in step args and set "
              "active: true on the steps to run")
        return 0
    if args.description:
        desc = WorkflowDescription.load(Path(args.description))
    else:
        default = store.workflow_dir / "workflow.yaml"
        if not default.exists():
            print("error: no workflow description (pass --description or put "
                  "workflow.yaml in the store's workflow dir)", file=sys.stderr)
            return 1
        desc = WorkflowDescription.load(default)
    if args.qc is not None:
        # the environment, as the reference sets it: every pipeline build
        # and the session read the gate when they run
        os.environ["TMX_QC"] = "1" if args.qc else "0"
    resilience = ResilienceConfig.from_library_config()
    if args.max_batch_failures is not None:
        resilience.max_batch_failures = args.max_batch_failures
    overrides = {k: v for k, v in (("max_attempts", args.retry_attempts),
                                   ("base_delay", args.retry_delay)) if v is not None}
    if overrides:
        resilience.policy = dataclasses.replace(resilience.policy, **overrides)
    # under torchrun each rank is one process of the group (NCCL on the
    # card, gloo on the CPU); without its environment this is a no-op
    distributed.initialize(device=args.device)
    summary = Workflow(store, desc, resilience=resilience, pipeline_depth=args.pipeline_depth,
                       device=args.device).run(resume=args.resume)
    if distributed.is_writer():
        print(json.dumps(summary, default=str, indent=2))
    return 0


def cmd_step(args) -> int:
    if args.verb == "args":
        print(json.dumps(get_step(args.command).batch_args.to_schema(), indent=2))
        return 0
    store = _open_store(args)
    step = get_step(args.command)(store, device=args.device)
    if args.verb == "init":
        step_args = {a.name: getattr(args, a.name) for a in step.batch_args
                     if getattr(args, a.name, None) is not None}
        batches = step.init(step_args)
        print(f"{args.command}: planned {len(batches)} batches")
        return 0
    if args.verb == "run":
        indices = [args.job] if args.job is not None else step.list_batches()
        for i in indices:
            result = step.run(i)
            print(f"{args.command} batch {i}: {json.dumps(result, default=str)}")
        return 0
    if args.verb == "collect":
        print(json.dumps(step.collect(), default=str))
        return 0
    if args.verb == "info":
        for i in step.list_batches():
            batch = step.load_batch(i)
            keys = {k: v for k, v in batch.items() if k != "args"}
            print(f"batch {i}: {json.dumps(keys, default=str)[:200]}")
        return 0
    if args.verb == "cleanup":
        _cleanup_step(step)
        print(f"{args.command}: outputs removed")
        return 0
    return 1


def _cleanup_step(step) -> None:
    """One step's cleanup (the per-step verb and the workflow-wide one):
    its outputs and its batch plans."""
    step.delete_previous_output()
    for p in step.step_dir.glob("batch_*.json"):
        p.unlink()


#: reader attributes ``inspect`` prints (whichever the reader has)
_INSPECT_ATTRS = (
    "height", "width", "n_channels", "n_zplanes", "n_tpoints",
    "n_series", "n_scenes", "n_tiles", "n_sequences", "n_components",
    "n_fields",
)


def _inspect_source_dir(src: Path) -> dict:
    """What ingest would make of a source directory, with no store: the
    sidecar handler that resolves it (metaconfig's ``auto`` order, the
    same :func:`resolve_sidecars` loop) and the layout it gives."""
    from tmlibrary_tpu_torch.errors import VendorConflictError
    from tmlibrary_tpu_torch.workflow.steps.vendors import SIDECAR_HANDLERS, resolve_sidecars

    try:
        resolved = resolve_sidecars(src, list(SIDECAR_HANDLERS), True)
    except VendorConflictError as exc:
        return {"format": "source-dir", "error": str(exc)}
    if resolved is None:
        return {
            "format": "source-dir",
            "handler": None,
            "note": "no sidecar handler resolved this directory; "
                    "metaconfig would fall back to filename patterns",
        }
    handler, entries, skipped = resolved
    wells = {(e["plate"], e["well_row"], e["well_col"]) for e in entries}
    return {
        "format": "source-dir",
        "handler": handler,
        "n_planes": len(entries),
        "n_skipped_files": skipped,
        "n_wells": len(wells),
        "n_sites": len({(e["plate"], e["well_row"], e["well_col"], e["site"])
                        for e in entries}),
        "channels": sorted({e["channel"] for e in entries}),
        "n_zplanes": max(e["zplane"] for e in entries) + 1,
        "n_tpoints": max(e["tpoint"] for e in entries) + 1,
        "n_cycles": max(e["cycle"] for e in entries) + 1,
    }


def _inspect_file(path: Path) -> dict:
    """Dimensions, channel names and ND2 loops of one file; a container
    that its TIFF-flavoured reader declines is inspected as a plain
    image, as ingest reads it."""
    from tmlibrary_tpu_torch import readers

    info: dict = {}
    r = readers._open_container(path)
    if r is None:
        plane = readers.ImageReader(path).read(0)
        info["format"] = "image"
        info["height"], info["width"] = map(int, plane.shape[:2])
        info["dtype"] = str(plane.dtype)
        return info
    try:
        info["format"] = type(r).__name__.replace("Reader", "")
        for attr in _INSPECT_ATTRS:
            val = getattr(r, attr, None)
            if val is not None:
                info[attr] = int(val)
        names = getattr(r, "channel_names", None)
        if callable(names):
            names = names()
        if names:
            info["channel_names"] = list(names)
        loops = getattr(r, "loop_shape", None)
        if callable(loops):
            loops = loops()
        if loops:  # ND2 acquisition nesting, outermost first
            info["loops"] = [[kind, size] for kind, size in loops]
    finally:
        r.__exit__()
    return info


def cmd_inspect(args) -> int:
    """``inspect``: a file's dimensions and channels, or a source
    directory's ingest preview; exits 1 when a file could not be read or
    a directory's wells conflict (an unresolved directory is an answer)."""
    failed = 0
    for name in args.files:
        path = Path(name)
        info: dict = {"file": str(path)}
        if path.is_dir() and not str(path).lower().endswith(".zarr"):
            info.update(_inspect_source_dir(path))
            failed += "error" in info
            if args.as_json:
                print(json.dumps(info))
            else:
                print(f"{info['file']}: source dir (handler={info.get('handler')})")
                for key, val in info.items():
                    if key not in ("file", "format", "handler"):
                        print(f"  {key:16s} {val}")
            continue
        try:
            info.update(_inspect_file(path))
        except Exception as exc:  # every failure is reported per file, as in the JAX package
            info["error"] = str(exc)
            failed += 1
        if args.as_json:
            print(json.dumps(info))
        else:
            print(f"{info['file']}: "
                  + (f"ERROR {info['error']}" if "error" in info else info.get("format", "?")))
            for key, val in info.items():
                if key not in ("file", "format", "error"):
                    print(f"  {key:14s} {val}")
    return 1 if failed else 0


def cmd_log(args) -> int:
    store = _open_store(args)
    if args.step:
        name = "run" if args.job is None else f"batch_{args.job:03d}"
        path = store.workflow_dir / args.step / "logs" / f"{name}.log"
        if not path.exists():
            print(f"error: no captured log at {path}", file=sys.stderr)
            return 1
        lines = path.read_text().splitlines()
        for line in lines[-args.tail:] if args.tail else lines:
            print(line)
        return 0
    for event in RunLedger(store.workflow_dir / "ledger.jsonl").events()[-args.tail:]:
        print(json.dumps(event, default=str))
    return 0


def cmd_qc(args) -> int:
    """A run's QC report and the drift verdict against a reference
    profile (the reference's ``cmd_qc``); returns the verdict's exit code,
    or 1 when the run has no QC evidence."""
    from tmlibrary_tpu_torch import qc as qc_mod

    wf = _open_store(args).workflow_dir
    pairs = qc_mod.load_run_profiles(wf)
    if pairs:
        profile = qc_mod.merge_profiles(pairs) if len(pairs) > 1 else pairs[0][1]
        source = f"qc.json x{len(pairs)} host(s)" if len(pairs) > 1 else "qc.json"
    else:
        events = RunLedger(wf / "ledger.jsonl").events()
        profile = qc_mod.qc_from_ledger(events) if events else {}
        source = "ledger"
    if not (profile.get("steps") or profile.get("channels")):
        print("no QC evidence for this run: submit with --qc (or TMX_QC=1) to collect it",
              file=sys.stderr)
        return 1
    kind = args.profile_kind
    if kind == "model":
        ref_path = args.reference or os.environ.get("TMX_QC_DL_BASELINE")
        if not qc_mod.filter_profile_kind(profile, "model").get("features"):
            print("no model-output sketches in this run's profile: the pipeline has no DL "
                  "modules or ran without --qc", file=sys.stderr)
            return 1
    else:
        ref_path = args.reference or os.environ.get("TMX_QC_BASELINE")
    profile = qc_mod.filter_profile_kind(profile, kind)
    reference = qc_mod.load_profile(Path(ref_path)) if ref_path else None
    reference = qc_mod.filter_profile_kind(reference, kind)
    verdict = qc_mod.compare_profiles(profile, reference, threshold=args.threshold,
                                      stale_hours=args.stale_hours)
    if args.as_json:
        print(json.dumps({"root": str(args.root), "source": source, "profile": profile,
                          "reference": ref_path, "verdict": verdict}, indent=2, default=float))
        return verdict["exit_code"]
    print(f"qc: {args.root}  (source: {source})")
    for name, e in sorted((profile.get("steps") or {}).items()):
        print(f"  {name:<16} batches {e.get('batches', 0):>5}  sites {e.get('sites', 0):>6}  "
              f"flagged {e.get('flagged', 0):>5}")
    for ch, metrics in sorted((profile.get("channels") or {}).items()):
        foc = (metrics.get("focus_tenengrad") or {}).get("min")
        sat = (metrics.get("saturation_frac") or {}).get("max")
        bits = [f"  {ch:<12}"]
        if foc is not None:
            bits.append(f"focus min {foc:.4g}")
        if sat is not None:
            bits.append(f"saturation max {sat:.2%}")
        print("  ".join(bits))
    if kind == "model":
        for name, sk in sorted((profile.get("features") or {}).items()):
            print(f"  {name:<28} n {int(sk.get('count') or 0):>8}  "
                  f"p50 {float(sk.get('p50') or 0.0):.4g}  p95 {float(sk.get('p95') or 0.0):.4g}")
    guards = profile.get("guards") or {}
    print(f"guards: nan columns {len(guards.get('nan_columns') or [])}  count z max "
          f"{float(guards.get('count_z_max') or 0.0):.2f}  flagged "
          f"{int(profile.get('flagged_total') or 0)} site(s)")
    for w in (profile.get("worst_sites") or [])[:max(args.worst, 0)]:
        print(f"  worst focus: site {w.get('site')} {w.get('channel')} {w.get('focus', 0.0):.4g}")
    line = f"drift verdict: {verdict['status']} (exit {verdict['exit_code']})"
    if reference is not None:
        line += f"  vs {ref_path}  checked {verdict.get('checked', 0)}"
    print(line)
    for d in verdict.get("drifted", [])[:10]:
        print(f"  DRIFT {json.dumps(d, default=float)}")
    return verdict["exit_code"]


def cmd_weights(args) -> int:
    """``weights list``: the checkpoints of the weights directory;
    ``weights digest SPEC``: the content digest a spec resolves to."""
    from tmlibrary_tpu_torch import nn

    if args.verb == "list":
        rows = nn.list_weights(args.dir)
        if args.as_json:
            print(json.dumps(rows, indent=2, default=str))
            return 0
        if not rows:
            print(f"no checkpoints in {args.dir or nn.weights_dir()}")
            return 0
        print(f"{'name':<24} {'digest':<14} {'arrays':>7} {'params':>10}")
        for r in rows:
            print(f"{r['name']:<24} {r['digest']:<14} {r['n_arrays']:>7} {r['n_params']:>10}")
        return 0
    _params, digest, config = nn.resolve_weights(args.spec)
    if args.as_json:
        print(json.dumps({"spec": args.spec, "digest": digest,
                          "config": dataclasses.asdict(config)}))
        return 0
    print(f"{args.spec}  digest {digest}  (in={config.in_channels}, "
          f"base={config.base_channels}, depth={config.depth})")
    return 0


def _query_payload(args) -> dict:
    """One query payload from --tool/--objects/--index and inline or file
    JSON; keys of the payload win over the shorthands."""
    if args.payload_file and args.payload:
        raise SystemExit("--payload and --payload-file are mutually exclusive")
    if args.payload_file:
        payload = json.loads(Path(args.payload_file).read_text())
    elif args.payload:
        payload = json.loads(args.payload)
    else:
        payload = {}
    if not isinstance(payload, dict):
        raise SystemExit("query payload must be a JSON object")
    if args.tool:
        payload.setdefault("tool", args.tool)
    if args.objects:
        payload.setdefault("objects_name", args.objects)
    if args.index:
        payload.setdefault("index", args.index)
    if not payload.get("objects_name"):
        raise SystemExit("query needs an objects_name (--objects or payload 'objects_name')")
    return payload


def cmd_query(args) -> int:
    from tmlibrary_tpu_torch.analytics import query as analytics_query

    store = _open_store(args)
    payload = _query_payload(args)
    summary = analytics_query.run_query(store, payload, use_cache=not args.no_cache,
                                        device=args.device)
    print(json.dumps(summary, default=str))
    return 0


def cmd_index(args) -> int:
    from tmlibrary_tpu_torch.analytics.index import IvfIndex
    from tmlibrary_tpu_torch.analytics.store import FeatureStore

    store = _open_store(args)
    fs = FeatureStore.ensure(store, args.objects)
    if args.verb == "build":
        features = ([f.strip() for f in args.features.split(",") if f.strip()]
                    if args.features else None)
        idx = IvfIndex.ensure(fs, features, n_cells=args.cells, rebuild=args.rebuild,
                              device=args.device)
        print(json.dumps({**idx.meta, "cache": idx.cache_state, "root": str(idx.root)},
                         default=str))
        return 0
    rows = []
    for meta_path in sorted((fs.root / "index").glob("*/index_meta.json")):
        try:
            meta = json.loads(meta_path.read_text())
        except ValueError:
            continue
        rows.append({
            "selection": meta.get("selection"),
            "n_cells": meta.get("n_cells"),
            "n_objects": meta.get("n_objects"),
            "recall_at_k": meta.get("recall_at_k"),
            "digest": meta.get("digest"),
            "state": "fresh" if meta.get("store_digest") == fs.digest else "stale",
            "root": str(meta_path.parent),
        })
    print(json.dumps({"objects_name": args.objects, "store_digest": fs.digest,
                      "indexes": rows}, default=str))
    return 0


def cmd_tool(args) -> int:
    from tmlibrary_tpu_torch.tools import base as tools_base

    if args.verb == "available":
        for name in tools_base.list_tools():
            print(name)
        return 0
    manager = tools_base.ToolRequestManager(_open_store(args), device=args.device)
    if args.verb == "submit":
        if args.payload_file and args.payload != "{}":
            raise SystemExit("--payload and --payload-file are mutually exclusive")
        payload = json.loads(Path(args.payload_file).read_text() if args.payload_file
                             else args.payload)
        if args.background:
            print(json.dumps(manager.status(manager.submit_async(args.name, payload)),
                             default=str))
            return 0
        result = manager.submit(args.name, payload)
        print(json.dumps({"tool": result.tool, "objects_name": result.objects_name,
                          "layer_type": result.layer_type,
                          "n_objects": tools_base.n_rows(result.values),
                          "attributes": result.attributes}, default=str))
        return 0
    if args.verb == "status":
        print(json.dumps(manager.status(args.request), default=str))
        return 0
    if args.verb == "run-request":
        manager.run_request(args.request)
        print(json.dumps(manager.status(args.request), default=str))
        return 0
    for entry in manager.list_requests():
        print(json.dumps(entry, default=str))
    return 0


def cmd_project(args) -> int:
    from tmlibrary_tpu_torch.jterator.project import Project

    if args.verb == "modules":
        from tmlibrary_tpu_torch.jterator.modules import list_modules

        for name in list_modules():
            print(name)
        return 0
    if args.verb == "create":
        Project.create(Path(args.dir), description=args.description)
        print(f"created project at {args.dir}")
        return 0
    if args.verb == "check":
        from tmlibrary_tpu_torch.errors import (
            PipelineDescriptionError,
            PipelineError,
            RegistryError,
        )
        from tmlibrary_tpu_torch.jterator.description import PipelineDescription
        from tmlibrary_tpu_torch.jterator.modules import get_module, module_accepts

        try:
            desc = PipelineDescription.load(Path(args.pipe))
        except (PipelineError, OSError, ValueError, KeyError) as e:
            # PipelineError covers the description and handle errors and
            # YAMLSubsetError; KeyError is a handle missing a field
            print(f"FAIL: cannot load pipeline: {e}")
            return 1
        problems: list[str] = []
        try:
            desc.validate()
        except PipelineDescriptionError as e:
            problems.append(str(e))
        for mod in desc.modules:
            try:
                get_module(mod.module, mod.backend)
            except RegistryError as e:
                problems.append(str(e))
                continue
            for name in list(mod.constants()) + list(mod.array_inputs()):
                if not module_accepts(mod.module, mod.backend, name):
                    problems.append(f"module '{mod.module}' has no parameter '{name}'")
        if problems:
            for problem in problems:
                print(f"FAIL: {problem}")
            return 1
        print(f"OK: {len(desc.modules)} modules, dataflow valid, every module and parameter "
              "resolves")
        return 0
    proj = Project(Path(args.dir))
    if args.verb == "add-module":
        hc = proj.add_module(args.module, instance=args.instance)
        print(f"added '{args.module}' as '{args.instance or args.module}' "
              f"({len(hc.input)} inputs, {len(hc.output)} outputs)")
        return 0
    if args.verb == "remove-module":
        proj.remove_module(args.instance)
        print(f"removed '{args.instance}'")
        return 0
    if args.verb == "add-channel":
        proj.add_channel(args.name, correct=not args.no_correct, align=args.align)
        print(f"added channel '{args.name}'")
        return 0
    if args.verb == "show":
        for name in proj.module_names():
            hc = proj.get_handles(name)
            print(f"{name}: module={hc.module} backend={hc.backend}")
        return 0
    return 1


def _export_images(store: ExperimentStore, args, out: Path) -> int:
    """One channel's site planes (optionally corrected and aligned) as
    uint16 TIFFs, every tpoint and zplane, named with the default
    filename handler's grammar
    (``[<plate>_]<well>_s<site>[_t<t>][_z<z>]_<channel>.tif``) so the tree
    re-ingests; ``--align`` crops to the stored intersection window.  The
    reference's ``_export_images`` (``tmlibrary_tpu/cli.py:1545``), which
    writes with ``cv2``; the port writes through
    :func:`~tmlibrary_tpu_torch.writers.encode_tiff` or, with ``--ome``,
    :class:`~tmlibrary_tpu_torch.writers.OMETiffWriter`."""
    import re

    import numpy as np
    import torch

    from tmlibrary_tpu_torch.device import resolve_device
    from tmlibrary_tpu_torch.errors import StoreError
    from tmlibrary_tpu_torch.models.experiment import Well
    from tmlibrary_tpu_torch.ops import image_ops
    from tmlibrary_tpu_torch.utils import create_partitions
    from tmlibrary_tpu_torch.writers import OMETiffWriter, encode_tiff, minimal_ome_xml

    device = resolve_device(args.device)
    channel, cycle = args.images, args.cycle
    exp = store.experiment
    # the default ingest pattern takes [A-Za-z0-9-] channel tokens and
    # [A-Za-z0-9] plate tokens only
    ch_name = re.sub(r"[^A-Za-z0-9\-]", "-", exp.channels[channel].name)
    plate_token = {p.name: re.sub(r"[^A-Za-z0-9]", "", p.name) or "plate" for p in exp.plates}
    out.mkdir(parents=True, exist_ok=True)

    mean_log = std_log = None
    if args.correct:
        if not store.has_illumstats(cycle=cycle, channel=channel):
            print("error: --correct requested but corilla stats are missing "
                  f"for cycle {cycle} channel {channel}", file=sys.stderr)
            return 1
        stats = store.read_illumstats(cycle=cycle, channel=channel)
        mean_log = torch.as_tensor(np.asarray(stats["mean_log"]), device=device)
        std_log = torch.as_tensor(np.asarray(stats["std_log"]), device=device)
    shifts = None
    window = None
    if args.align:
        if not store.has_shifts(cycle):
            print(f"error: --align requested but no shifts stored for cycle {cycle} (run "
                  "the align step)", file=sys.stderr)
            return 1
        shifts = store.read_shifts(cycle)
        try:
            w = store.read_intersection()
            window = (w["top"], w["bottom"], w["left"], w["right"])
        except StoreError:
            pass  # align ran but no intersection stored: shift only
        if window is not None and not any(window):
            window = None
    prep = image_ops.make_batch_prep(mean_log, std_log, window,
                                     apply_shift=shifts is not None)

    # site index within the well (row-major over the well grid)
    refs = list(exp.sites())
    spw_x = max((r.site_x for r in refs), default=0) + 1
    multi_plate = len(exp.plates) > 1
    shift_table = shifts if shifts is not None else np.zeros((len(refs), 2), np.int32)
    n = 0
    for tpoint in range(exp.n_tpoints):
        for zplane in range(exp.n_zplanes):
            for part in create_partitions(list(range(len(refs))), 32):
                stack = store.read_sites(part, cycle=cycle, channel=channel, tpoint=tpoint,
                                         zplane=zplane)
                prepped = prep(torch.as_tensor(stack.astype(np.int32), device=device),
                               torch.as_tensor(np.asarray(shift_table)[part], device=device))
                prepped = prepped.cpu().numpy()
                for b, idx in enumerate(part):
                    ref = refs[idx]
                    arr = np.clip(prepped[b], 0, 65535).astype(np.uint16)
                    well = Well(row=ref.well_row, column=ref.well_column, sites=())
                    name = f"{well.name}_s{ref.site_y * spw_x + ref.site_x:d}"
                    if multi_plate:
                        name = f"{plate_token[ref.plate]}_{name}"
                    if exp.n_tpoints > 1:
                        name += f"_t{tpoint:d}"
                    if exp.n_zplanes > 1:
                        name += f"_z{zplane:d}"
                    name += f"_{ch_name}.tif"
                    if args.ome:
                        OMETiffWriter(out / name).write(arr, minimal_ome_xml(name, *arr.shape))
                    else:
                        (out / name).write_bytes(encode_tiff(arr))
                    n += 1
    print(f"wrote {n} {ch_name} site images to {out}")
    return 0


def _csv_cell(value) -> str:
    """A cell as ``DataFrame.to_csv`` writes it: NaN as empty, floats by
    their shortest repr, the rest by ``str``."""
    if isinstance(value, float) and value != value:
        return ""
    return str(value)


def _write_csv(path: Path, table: dict) -> None:
    """The columns of ``table`` as ``DataFrame.to_csv(index=False)``
    writes them (``csv.QUOTE_MINIMAL``, ``\\n`` line ends)."""
    import csv

    names = list(table)
    columns = [table[k].tolist() for k in names]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        for row in zip(*columns):
            writer.writerow([_csv_cell(v) for v in row])


def _geojson_features(store: ExperimentStore, args) -> "list[dict] | int":
    """The GeoJSON features of the polygon shards, with ``--join-features``
    columns joined by (site, label) as the reference's left merge joins
    them, and rings simplified by ``--simplify``; an int exit code on a
    user error."""
    import numpy as np

    from tmlibrary_tpu_torch import native
    from tmlibrary_tpu_torch.io import parquet

    shards = sorted((store.root / "segmentations").glob(f"{args.objects}_polygons_*.parquet"))
    if not shards:
        print(f"error: no polygon shards for '{args.objects}' — run jterator with "
              "--as-polygons", file=sys.stderr)
        return 1
    parts = [parquet.read_table(p) for p in shards]
    names = list(parts[0])
    rows = [{k: part[k][i] for k in names} for part in parts
            for i in range(len(part[names[0]]))]
    wanted: list[str] = []
    if args.join_features:
        wanted = [c.strip() for c in args.join_features.split(",") if c.strip()]
        keys = {"label", "site_index", "site"}
        if keys & set(wanted):
            print(f"error: --join-features cannot include the join keys "
                  f"{sorted(keys & set(wanted))}", file=sys.stderr)
            return 1
        feats = store.read_features(args.objects)
        missing = [c for c in wanted if c not in feats]
        if missing:
            print(f"error: --join-features columns not in the feature table: {missing} "
                  f"(available: {sorted(set(feats) - {'label'})[:20]}...)", file=sys.stderr)
            return 1
        matches: dict[tuple, list[int]] = {}
        for i, key in enumerate(zip(feats["site_index"].tolist(), feats["label"].tolist())):
            matches.setdefault(key, []).append(i)
        joined = []
        for row in rows:
            hits = matches.get((int(row["site"]), int(row["label"])), [None])
            for i in hits:
                extra = {c: (None if i is None or feats[c][i] != feats[c][i]
                             else feats[c][i]) for c in wanted}
                joined.append({**row, **extra})
        rows = joined
    features = []
    for row in rows:
        contour = np.stack([np.asarray(row["contour_y"]), np.asarray(row["contour_x"])], axis=1)
        if args.simplify > 0:
            contour = native.simplify_polygon_host(contour, args.simplify)
        ring = [[float(x), float(y)] for y, x in contour]
        if ring and ring[0] != ring[-1]:
            ring.append(ring[0])  # GeoJSON rings are closed
        props = {k: (v.item() if hasattr(v, "item") else v) for k, v in row.items()
                 if k not in ("contour_y", "contour_x")}
        features.append({"type": "Feature",
                         "geometry": {"type": "Polygon", "coordinates": [ring]},
                         "properties": props})
    return features


def cmd_export(args) -> int:
    """A combined per-object feature table (Parquet or CSV), the polygons
    as GeoJSON, one channel's site images, or the whole plate as
    OME-NGFF -- the reference's ``cmd_export``
    (``tmlibrary_tpu/cli.py:1656``).  ``--illumstats`` writes HDF5 there
    (h5py), which the target machine lacks: it raises
    :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`."""
    store = _open_store(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    modes = [m for m, v in (("--objects", args.objects), ("--illumstats", args.illumstats),
                            ("--images", args.images), ("--ngff", args.ngff or None))
             if v is not None]
    if len(modes) > 1:
        print(f"error: {' and '.join(modes)} are mutually exclusive", file=sys.stderr)
        return 1
    if args.ngff:
        from tmlibrary_tpu_torch.ngff import write_ngff_plate

        label_names = ([n.strip() for n in args.ngff_labels.split(",") if n.strip()]
                       if args.ngff_labels else None)
        write_ngff_plate(store, out, n_levels=args.ngff_levels, label_names=label_names)
        extra = f" + labels {','.join(label_names)}" if label_names else ""
        print(f"wrote OME-NGFF 0.4 HCS plate ({len(store.experiment.channels)} channels"
              f"{extra}) to {out}")
        return 0
    if args.images is not None:
        return _export_images(store, args, out)
    if args.illumstats is not None:
        from tmlibrary_tpu_torch.errors import NotSupportedError

        raise NotSupportedError("--illumstats writes HDF5 (h5py), which the target machine "
                                "lacks (ROADMAP A item 12b)")
    if args.objects is None:
        print("error: pass --objects NAME (feature/polygon export) or --illumstats CHANNEL",
              file=sys.stderr)
        return 1
    suffix_fmt = {".csv": "csv", ".geojson": "geojson", ".json": "geojson"}
    fmt = args.format or suffix_fmt.get(out.suffix.lower(), "parquet")
    if fmt == "geojson":
        features = _geojson_features(store, args)
        if isinstance(features, int):
            return features
        out.write_text(json.dumps({"type": "FeatureCollection", "features": features}))
        print(f"wrote {len(features)} polygon features to {out}")
        return 0
    from tmlibrary_tpu_torch.io import parquet

    table = store.read_features(args.objects)
    if fmt == "csv":
        _write_csv(out, table)
    else:
        parquet.write_table(out, table)
    n_rows = len(next(iter(table.values()))) if table else 0
    print(f"wrote {n_rows} rows x {len(table)} cols to {out}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    level = max(logging.DEBUG, logging.WARNING - 10 * getattr(args, "verbosity", 0))
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("tmlibrary_tpu_torch").setLevel(level)
    try:
        if args.command == "create":
            return cmd_create(args)
        if args.command == "workflow":
            return cmd_workflow(args)
        if args.command == "inspect":
            return cmd_inspect(args)
        if args.command == "log":
            return cmd_log(args)
        if args.command == "qc":
            return cmd_qc(args)
        if args.command == "weights":
            return cmd_weights(args)
        if args.command == "query":
            return cmd_query(args)
        if args.command == "index":
            return cmd_index(args)
        if args.command == "tool":
            return cmd_tool(args)
        if args.command == "project":
            return cmd_project(args)
        if args.command == "export":
            return cmd_export(args)
        return cmd_step(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
