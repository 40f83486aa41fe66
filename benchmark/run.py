"""The benchmark of vc2tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/``) and a
traffic mix (``traffic/``). The run makes the mix's pictures from the seed
on the card; a decode cell's stream is written by the reference codec
(``reference/``), never by the program. It then calls the port's stream
CLI, ``vc2tpu_torch.cli.decode_stream.main`` or ``encode_stream.main``,
with input and output ``-``, in this process: ``sys.stdin`` and
``sys.stdout`` are stand-ins whose ``buffer`` is the harness's reader and
sink (``loop.py``). The window opens when the warm-up pictures have come
out of that call, and the reader ends the input ``--seconds`` later.
Once the CLI has returned, the reference codes the pictures again where
the run did not need them before, and the window's sampled outputs are
compared with it (``check.py``).

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
taken on the host clock (``setup_s``: from the process's start to the
window's opening, less the seconds the reference spends coding a decode
cell's stream, which are the check's and not the program's); with
``--trace 1`` its per-layer metrics (``metrics/<name>.py``), read from
the spans and the profiler's trace of the window (``tracing.py``), with
the device's busy and window seconds and a breakdown. The last line of standard output is the result, one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error. Per-picture stamps, the card's clocks and power beside
the window and the traced run's kernel table go to a file under
``$TMPDIR``. Without a card (or with fewer than the cell asks for) the
run exits 3 and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "vc2tpu")
SMI = ("nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
       "power.limit,temperature.gpu", "--format=csv,noheader")
CLIS = {"decode": "vc2tpu_torch.cli.decode_stream",
        "encode": "vc2tpu_torch.cli.encode_stream"}
PHASES: dict = {}       # seconds from the start at each step of the set-up
# a traced run profiles the window's first seconds: the profiler's records
# of a whole window take longer to reduce than a run may last
TRACED_S = 5.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_of(name: str) -> tuple:
    """(manifest, cell, configuration, traffic) of workload ``name``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return manifest, cell, config, traffic


def reported(entries: list, cell: dict, e2e: set | None = None) -> list:
    """The metrics of ``entries`` the cell reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif e2e is None or m.get("moves") in e2e:
            out.append(m)
    return out


def smi() -> str:
    """One line of the card's name, clocks, power and temperature."""
    try:
        out = subprocess.run(SMI, capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest, cell, config, traffic = cell_of(args.workload)
    import torch

    PHASES["torch imported"] = time.perf_counter() - START
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this run needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    return measure(args, manifest, cell, config, traffic,
                   torch.device("cuda", 0))


def measure(args, manifest, cell, config, traffic, device,
            cli_module=None) -> int:
    """One run of ``cell`` on ``device``: set-up, the window, the check and
    the result. ``cli_module`` replaces the CLI's module (the tests)."""
    import torch

    import check
    import loop
    import pictures
    import tracing
    from measure import Run, load, nearest_rank
    from reference.codec import Codec

    direction = traffic["direction"]
    cli = cli_module or importlib.import_module(CLIS[direction])
    on_card = device.type == "cuda"
    codec = Codec(config["coding"], device)
    planes, planar = pictures.make(config["coding"], traffic["pictures"],
                                   args.seed, device)
    PHASES["pictures made"] = time.perf_counter() - START
    coded = None
    reference_s = 0.0       # the reference's own seconds: not set-up
    if direction == "decode":
        coded = codec.encode(planes)
        PHASES["reference stream coded"] = time.perf_counter() - START
        reference_s = (PHASES["reference stream coded"]
                       - PHASES["pictures made"])
        planes = planar = None
        header = codec.header_unit()
        first_prev = 13 + len(codec.header)

        def pieces(i: int) -> list:
            body = coded[i % len(coded)].body
            prev = first_prev if i == 0 else 13 + 4 + len(
                coded[(i - 1) % len(coded)].body)
            head = codec.unit_head(i & 0xFFFFFFFF, len(body), prev)
            return ([header] if i == 0 else []) + [head, body]

        argv = [*config.get("decode_flags", []), "-", "-"]
    else:
        def pieces(i: int) -> list:
            return [planar[i % len(planar)]]

        argv = [*config["encode_flags"], "-", "-"]
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    spans = profile = None
    per_layer = reported(manifest["per_layer"], cell, {
        m["name"] for m in reported(manifest["end_to_end"], cell)})
    if args.trace:
        spans = tracing.Spans()
        with open(os.path.join(HERE, "spans.json")) as f:
            labels = json.load(f)["spans"]
        for name, (module, attribute) in labels[direction].items():
            spans.wrap(name, module, attribute)
        for m in per_layer:
            for name, targets in load("metrics", m["name"]).SPANS.items():
                for module, attribute in targets:
                    spans.wrap(name, module, attribute)
        profile = tracing.Profile(on_card)
        profile.warm()

    window = loop.Window(traffic["warmup"], args.seconds,
                         on_open=profile.start if profile else None,
                         on_close=profile.stop if profile else None,
                         traced=TRACED_S)
    reader = loop.Reader(pieces, window, traffic.get("rate"))
    if direction == "decode":
        sink = loop.PlanarSink(sum(h * w for h, w in codec.dims)
                               * (1 if codec.bits == 8 else 2), window,
                               traffic["sample_every"], args.seed)
    else:
        sink = loop.UnitSink(window, traffic["sample_every"], args.seed)
    if spans is not None:
        spans.wrap_on("input.read", reader, "read")
        spans.wrap_on("output.write", sink, "write")

    smi_before = smi() if on_card else "no card"
    saved = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = loop.Stdin(reader), loop.Stdout(sink, sys.stderr)
    try:
        rc = cli.main(argv)
    finally:
        sys.stdin, sys.stdout = saved
        if spans is not None:
            spans.restore()
    if on_card:
        torch.cuda.synchronize(device)
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    smi_after = smi() if on_card else "no card"
    if window.open_at is None or window.closed_at is None:
        what = "open" if window.open_at is None else "close"
        print(f"the window did not {what} (rc {rc}, {len(window.done)} "
              "pictures out)", file=sys.stderr)
        return 1
    setup_s = window.open_at - START - reference_s
    PHASES["first picture out"] = window.done[0] - START
    PHASES["window open"] = window.open_at - START

    if direction == "encode":
        coded = codec.encode(planes)
    numbers = check.judge(direction, window, sink, codec, coded)
    correct = rc == 0 and check.passed(numbers) and numbers["sampled"][0] > 0

    run = Run(cell, config, traffic, window, spans, None, coded, codec)
    done = run.in_window()
    latencies = [run.latency_ms(i) for i in done]
    e2e = {m["name"]: m for m in reported(manifest["end_to_end"], cell)}
    values = {"setup_s": (setup_s, "s")}
    if latencies:
        p95 = nearest_rank(latencies, 95)
        fps = len(done) / args.seconds
        values.update({f"{direction}_fps": (fps, "pictures/s"),
                       f"{direction}_p95_ms": (p95, "ms")})
    result = {"correct": correct, "attempted": len(window.handed),
              "failed": numbers["missing"][0] + numbers["differ"][0]}
    breakdown = None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        run.trace = profile.reduce()
        metrics = {}
        for m in per_layer:
            value = load("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_by_span()}
    else:
        metrics = {name: {"value": values[name][0], "unit": values[name][1]}
                   for name in e2e if name in values}
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown

    evidence = write_evidence(args, cell, window, run, latencies,
                              smi_before, smi_after, numbers, result,
                              setup_s)
    if latencies:
        print(f"latency ms over {len(latencies)} pictures in the window: "
              f"median {nearest_rank(latencies, 50)}, p95 "
              f"{nearest_rank(latencies, 95)}, p99 "
              f"{nearest_rank(latencies, 99)}; generator late at most "
              f"{1e3 * max(window.late, default=0.0)} ms; host in the window: "
              f"{window.host_usage()}; set-up (s from the start): {PHASES}; "
              f"card before: "
              f"{smi_before}; after: {smi_after}; stamps: {evidence}",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    if len(e2e) and not args.trace and set(e2e) - set(metrics):
        print(f"no reading of {sorted(set(e2e) - set(metrics))}",
              file=sys.stderr)
        return 1
    compared = {name: {"value": v, "limit": lim}
                for name, (v, lim) in numbers.items()}
    for name, c in compared.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result["checks"] = compared
    print(json.dumps(result))
    return 0


def write_evidence(args, cell, window, run, latencies, smi_before, smi_after,
                   numbers, result, setup_s) -> str:
    """The run's stamps and readings, as JSON under ``$TMPDIR``."""
    t0 = window.open_at
    record = {
        "workload": cell["name"], "seed": args.seed, "trace": args.trace,
        "seconds": args.seconds, "setup_s": setup_s,
        "card_before": smi_before, "card_after": smi_after,
        "stamps_from_open_s": {
            "handed": [t - t0 for t in window.handed],
            "due": [t - t0 for t in window.due],
            "late": window.late, "done": [t - t0 for t in window.done]},
        "setup_phases_s": PHASES, "host_usage": window.host_usage(),
        "latency_ms": latencies,
        "checks": numbers, "result": result}
    if run.trace is not None:
        record["kernels"] = {name: run.trace.device_ms(
            lambda n, name=name: n == name) for name, _s in
            run.trace.top_ops(50)}
        record["device_op_names"] = sorted({n for n, _s, _d in
                                            run.trace.ops})[:200]
    path = os.path.join(tempfile.gettempdir(),
                        f"bench-{cell['name']}-{args.seed}-{args.trace}.json")
    with open(path, "w") as f:
        json.dump(record, f)
    return path


if __name__ == "__main__":
    sys.exit(main())
