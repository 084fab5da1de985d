"""Command-line interface of the port.

Counterpart: ``tmlibrary_tpu/cli.py`` (``tmx``), with the verbs of the
steps the port has, the same argument names and the same JSON output::

    python -m tmlibrary_tpu_torch.cli create --root DIR --name NAME
    python -m tmlibrary_tpu_torch.cli workflow submit --root DIR [--description wf.json]
                                                      [--resume] [--device cuda] [--qc|--no-qc]
    python -m tmlibrary_tpu_torch.cli workflow resume --root DIR ...
    python -m tmlibrary_tpu_torch.cli workflow status --root DIR
    python -m tmlibrary_tpu_torch.cli <step> init|run|collect|info|args --root DIR ...
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
``tmx-torch``.  ``create`` makes the placeholder store a canonical run
starts from (metaconfig writes its manifest).  The step verbs and
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

    p_log = sub.add_parser("log", help="show the run ledger or captured step logs")
    _add_common(p_log)
    p_log.add_argument("--tail", type=int, default=20)
    p_log.add_argument("--step", default=None, help="print a step's captured log file instead")
    p_log.add_argument("--job", type=int, default=None,
                       help="batch index (with --step); omit for the whole-step run log")

    p_wf = sub.add_parser("workflow", help="full workflow orchestration")
    wf_sub = p_wf.add_subparsers(dest="verb", required=True)
    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("--description",
                        help="workflow description, JSON (default: the store's "
                             "workflow/workflow.json)")
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
    if args.description:
        desc = WorkflowDescription.load(Path(args.description))
    else:
        default = store.workflow_dir / "workflow.json"
        if not default.exists():
            print("error: no workflow description (pass --description or put "
                  "workflow.json in the store's workflow dir)", file=sys.stderr)
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
    return 1


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
        return cmd_step(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
