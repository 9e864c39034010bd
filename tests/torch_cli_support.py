"""Shared harness of the port's CLI parity tests (``test_torch_cli.py``,
``test_torch_debate.py``, ``test_torch_loader.py``, ``test_torch_pool.py``):
isolation of the port's process-wide state, a
CLI runner that works for both packages, and the normalization that
strips wall-clock fields before two ``--json`` reports are compared.

The reference package's state is isolated by ``tests/conftest.py``; the
port keeps its own copies of every module with process-wide state, and
``isolate_port`` resets those the same way.
"""

import io
import json
from pathlib import Path

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu import fleet as ref_fleet
from adversarial_spec_tpu.debate import profiles as ref_profiles
from adversarial_spec_tpu.debate import session as ref_session
from adversarial_spec_tpu.engine import interleave as ref_interleave
from adversarial_spec_tpu.engine import registry as ref_registry
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch import fleet as port_fleet
from adversarial_spec_tpu_torch import obs as port_obs
from adversarial_spec_tpu_torch import serve as port_serve
from adversarial_spec_tpu_torch.debate import profiles as port_profiles
from adversarial_spec_tpu_torch.debate import session as port_session
from adversarial_spec_tpu_torch.engine import dispatch as port_dispatch
from adversarial_spec_tpu_torch.engine import interleave as port_interleave
from adversarial_spec_tpu_torch.engine import kvtier as port_kvtier
from adversarial_spec_tpu_torch.engine import prefix_cache as port_prefix
from adversarial_spec_tpu_torch.engine import registry as port_registry
from adversarial_spec_tpu_torch.engine import spec as port_spec
from adversarial_spec_tpu_torch.engine import streaming as port_streaming
from adversarial_spec_tpu_torch.engine import weightres as port_weightres
from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
from adversarial_spec_tpu_torch.resilience import breaker as port_breaker
from adversarial_spec_tpu_torch.resilience import faults as port_faults
from adversarial_spec_tpu_torch.resilience import injector as port_injector
from adversarial_spec_tpu_torch.resilience import lockdep as port_lockdep
from adversarial_spec_tpu_torch.serve import gate as port_gate

# Wall-clock fields of a ``--json`` critique report: ``perf.total_s``,
# every value of ``perf.spans`` and every ``total_s`` of
# ``perf.span_tree`` (keys and counts stay). Nothing else in a mock
# report reads a clock: the mock engine's walls are synthetic.
WALL_CLOCK_FIELDS = ("perf.total_s", "perf.spans.*", "perf.span_tree.**.total_s")

# Fields where the port reports a subsystem it does not have, or has
# only in part: (path, the port's value). Removed from both reports after
# the port's value is checked.
KNOWN_DIFFERENCES = (
    # Pipeline depth 2 is not ported; the reference's default is 2.
    (("perf", "interleave", "pipeline_depth"), 1),
)


def point_state(
    monkeypatch, pkg: str, root: Path, registry_path: Path | None = None
) -> None:
    """Point one package's persistence paths under ``root`` (its
    registry at ``registry_path`` when given)."""
    session, profiles, registry = (
        (ref_session, ref_profiles, ref_registry)
        if pkg == "ref"
        else (port_session, port_profiles, port_registry)
    )
    monkeypatch.setattr(session, "SESSIONS_DIR", root / "sessions")
    monkeypatch.setattr(session, "CHECKPOINTS_DIR", root / "checkpoints")
    monkeypatch.setattr(profiles, "PROFILES_DIR", root / "profiles")
    monkeypatch.setattr(profiles, "GLOBAL_CONFIG_PATH", root / "config.json")
    monkeypatch.setattr(
        registry, "REGISTRY_PATH", registry_path or root / "registry.json"
    )


def reset_fleet(fleet) -> None:
    """Every knob of one package's fleet at its default, no process fleet
    and zeroed stats (the reference's conftest resets only some knobs, and
    its autoscaler tests set the others)."""
    fleet.shutdown_fleet()
    fleet.configure(
        enabled=False,
        replicas=fleet.DEFAULT_REPLICAS,
        transport="inproc",
        request_timeout_s=30.0,
        autoscale=False,
        min_replicas=fleet.DEFAULT_MIN_REPLICAS,
        max_replicas=fleet.DEFAULT_MAX_REPLICAS,
        scale_out_fraction=fleet.DEFAULT_SCALE_OUT_FRACTION,
        scale_in_fraction=fleet.DEFAULT_SCALE_IN_FRACTION,
        scale_out_ticks=fleet.DEFAULT_SCALE_OUT_TICKS,
        scale_in_ticks=fleet.DEFAULT_SCALE_IN_TICKS,
        scale_cooldown_s=fleet.DEFAULT_SCALE_COOLDOWN_S,
        scale_interval_s=fleet.DEFAULT_SCALE_INTERVAL_S,
        spawn_retries=fleet.DEFAULT_SPAWN_RETRIES,
        prefill_replicas=fleet.DEFAULT_PREFILL_REPLICAS,
        handoff_threshold_tokens=fleet.DEFAULT_HANDOFF_THRESHOLD_TOKENS,
        min_prefill_replicas=fleet.DEFAULT_MIN_PREFILL_REPLICAS,
        max_prefill_replicas=fleet.DEFAULT_MAX_PREFILL_REPLICAS,
    )
    fleet.reset_stats()


def reset_port_process() -> None:
    """What a new process of the port starts from: no engines and no
    fleet, closed breakers, no faults, no injector, default knobs,
    empty obs."""
    port_dispatch.clear_engine_cache()
    reset_fleet(port_fleet)
    port_breaker.reset_default_registry()
    port_faults.reset()
    port_injector.reset()
    port_prefix.configure(enabled=True, max_pages=0)
    port_prefix.reset_stats()
    # The suite runs with ADVSPEC_KV_TIER=0 (tests/conftest.py pins the
    # reference's tiers off); a new port process starts so too.
    port_kvtier.configure(
        enabled=False,
        host_mb=port_kvtier.DEFAULT_HOST_MB,
        store_dir="",
        flush_blocks=0,
    )
    port_kvtier.reset_stats()
    port_weightres.configure(
        enabled=True, host_mb=port_weightres.DEFAULT_HOST_MB
    )
    port_weightres.reset_stats()
    # Speculation as a new process reads it from its env (a serve
    # brownout retunes gamma process-wide).
    port_spec.configure(enabled=port_spec.env_enabled(), gamma=port_spec.env_gamma())
    port_spec.reset_stats()
    port_streaming.configure(enabled=True, early_cancel=True)
    port_streaming.reset_stats()
    port_interleave.configure(enabled=True)
    port_interleave.reset_stats()
    port_obs.configure(
        enabled=True,
        recorder_size=port_obs.DEFAULT_RECORDER_SIZE,
        events_out="",
        dump_on_fault=True,
        arrivals=False,
    )
    port_obs.reset_stats()
    port_obs.retrace.clear()
    # The serve daemon's state is process-wide (armed once at startup):
    # a leaked gate would route every later engine call through a dead
    # scheduler.
    port_gate.uninstall()
    port_serve.configure(
        max_queue_depth=port_serve.DEFAULT_QUEUE_DEPTH,
        max_backlog_tokens=port_serve.DEFAULT_BACKLOG_TOKENS,
        tenant_quota_tokens=0,
        drain_deadline_s=port_serve.DEFAULT_DRAIN_DEADLINE_S,
        brownout_enter_fraction=port_serve.DEFAULT_BROWNOUT_ENTER_FRACTION,
        brownout_exit_fraction=port_serve.DEFAULT_BROWNOUT_EXIT_FRACTION,
        brownout_gamma=port_serve.DEFAULT_BROWNOUT_GAMMA,
        preempt_grace_s=0.0,
        interactive_ttft_slo_ms=0.0,
        max_dispatch_batch=4,
        max_debates_in_flight=32,
    )
    port_serve.reset_stats()


def isolate_port(tmp_path: Path, monkeypatch):
    """Generator body of the port's autouse fixture: the port's state
    under ``tmp_path`` (the reference's registry file is shared, as it
    is in production), reset before and after, lockdep clean."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("ADVSPEC_SESSIONS_DIR", str(tmp_path / "sessions"))
    point_state(monkeypatch, "port", tmp_path)
    monkeypatch.delenv("ADVSPEC_PIPELINE_DEPTH", raising=False)
    for var in (
        "ADVSPEC_SERVE_QUEUE_DEPTH",
        "ADVSPEC_SERVE_BACKLOG_TOKENS",
        "ADVSPEC_SERVE_QUOTA_TOKENS",
        "ADVSPEC_SERVE_DRAIN_DEADLINE_S",
        "ADVSPEC_SERVE_TTFT_SLO_MS",
        "ADVSPEC_SERVE_SOCKET",
    ):
        monkeypatch.delenv(var, raising=False)
    # The reference keeps its pipeline depth across invocations unless a
    # flag sets it; start each test from its default.
    ref_interleave.configure(
        enabled=True, pipeline_depth=ref_interleave.MAX_PIPELINE_DEPTH
    )
    reset_port_process()
    reset_fleet(ref_fleet)
    port_lockdep.reset()
    yield
    leaked = port_lockdep.violations()
    assert not leaked, "\n\n".join(str(v) for v in leaked)
    port_lockdep.reset()
    reset_port_process()
    reset_fleet(ref_fleet)
    ref_interleave.configure(
        enabled=True, pipeline_depth=ref_interleave.MAX_PIPELINE_DEPTH
    )


def run_cli(cli_mod, argv, monkeypatch, capsys, stdin=None):
    """One ``main(argv)`` → (exit code, stdout, stderr)."""
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin or ""))
    try:
        code = cli_mod.main(list(argv))
    except SystemExit as e:  # argparse refusals exit before main's try
        code = int(e.code or 0)
    out, err = capsys.readouterr()
    return code, out, err


def _strip(doc, path: tuple) -> None:
    """Delete the field at ``path`` ("*" = every key, "**" = any depth)."""
    if not isinstance(doc, dict) or not path:
        return
    head, rest = path[0], path[1:]
    if head == "**":
        _strip(doc, rest)
        for v in doc.values():
            _strip(v, path)
        return
    keys = list(doc) if head == "*" else [head] if head in doc else []
    for k in keys:
        if rest:
            _strip(doc[k], rest)
        else:
            del doc[k]


def normalize_report(doc, pkg: str):
    """A ``--json`` document without its wall-clock fields, and with the
    port's known differences checked and removed. Non-report documents
    (lists, other actions' objects) pass through."""
    if not isinstance(doc, dict) or "perf" not in doc:
        return doc
    doc = json.loads(json.dumps(doc))
    for field in WALL_CLOCK_FIELDS:
        _strip(doc, tuple(field.split(".")))
    for path, port_value in KNOWN_DIFFERENCES:
        node = doc
        for k in path[:-1]:
            node = node[k]
        value = node.pop(path[-1])
        assert pkg == "ref" or value == port_value, (path, value)
    # Host-sync counters reset to zero in place, so a reason that an
    # earlier test in the same process counted stays listed at 0: a
    # zero entry is process history, not this round's.
    syncs = doc["perf"].get("obs", {}).get("host_syncs")
    if syncs:
        doc["perf"]["obs"]["host_syncs"] = {k: v for k, v in syncs.items() if v}
    return doc


def normalize_stdout(out: str, pkg: str, root: Path | None = None):
    """Parsed and normalized when the output is one JSON document (the
    ``sessions --json`` listing loses its save times); else the text
    with the package's state root replaced by ``<root>``."""
    try:
        doc = json.loads(out)
    except ValueError:
        return out.replace(str(root), "<root>") if root else out
    if isinstance(doc, list):
        for item in doc:
            if isinstance(item, dict):
                item.pop("created_at", None)
                item.pop("updated_at", None)
    return normalize_report(doc, pkg)


def normalize_stderr(err: str, root: Path | None = None) -> str:
    """The human progress lines without the round wall, and with the
    package's state root replaced by ``<root>``."""
    if root:
        err = err.replace(str(root), "<root>")
    return "\n".join(
        "perf: round <wall>" + line[line.index("s,") + 1 :]
        if line.startswith("perf: round ")
        else line
        for line in err.splitlines()
    )


def _normalize_file(path: Path) -> bytes | object:
    data = path.read_bytes()
    if path.suffix == ".json":
        doc = json.loads(data)
        if isinstance(doc, dict):
            # Session files: save times, and each breaker's cooldown
            # left at the save (read off the clock).
            doc.pop("created_at", None)
            doc.pop("updated_at", None)
            for state in (doc.get("breakers") or {}).values():
                state.pop("cooldown_remaining", None)
        return doc
    if path.suffix == ".jsonl":
        recs = []
        for line in data.decode().splitlines():
            rec = json.loads(line)
            rec.pop("latency_s", None)
            rec.pop("ts", None)
            recs.append(rec)
        return recs
    return data


def state_tree(root: Path) -> dict:
    """Every file the CLI wrote under ``root`` (sessions, checkpoints,
    journals, profiles), with wall-clock stamps removed."""
    return {
        str(p.relative_to(root)): _normalize_file(p)
        for p in sorted(root.rglob("*"))
        if p.is_file()
    }


def both_cli(argv, tmp_path, monkeypatch, capsys, stdin=None):
    """One invocation through each CLI (the port's serving through a CPU
    GpuEngine), each with its own sessions: (code, stdout, stderr) each."""
    out = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        point_state(monkeypatch, pkg, tmp_path / pkg, tmp_path / "registry.json")
        if pkg == "port" and not port_dispatch.cached_engines():
            port_dispatch.install_engine("tpu://x", GpuEngine(device="cpu"))
        out.append(run_cli(cli_mod, argv, monkeypatch, capsys, stdin))
    return out


def without_walls(doc):
    """A ``--json`` report without its wall-clock fields: the harness's
    list (``normalize_report``), and every ``*_s`` / ``*_per_sec``
    timing of the rows, the cost table and perf (a ``tpu://`` round times
    real work, unlike the mock engine's synthetic walls)."""
    def strip(node):
        if isinstance(node, dict):
            return {
                k: strip(v) for k, v in node.items()
                if not (k.endswith("_s") or k.endswith("_per_sec"))
            }
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(doc)
