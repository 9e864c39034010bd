"""The port's ``critique`` CLI against the reference's, on ``mock://``.

Every scenario of ``tests/test_cli.py`` and ``tests/test_e2e_debate.py``
that the mock engine serves runs here as one case of a parametrised
test: the same argv sequence goes through ``adversarial_spec_tpu.cli``
and ``adversarial_spec_tpu_torch.cli``, each package with its own
sessions, checkpoints, profiles and registry under ``tmp_path``. Exit
codes, stdout (text, or ``--json`` without the wall-clock fields that
``torch_cli_support.WALL_CLOCK_FIELDS`` lists), stderr (without the
round wall), and every file written (sessions, checkpoints, journals,
profiles, ``--events-out``) must be equal.

Beside them: a session the reference started resumes under the port;
each knob of an unported subsystem exits 2 with "not yet ported" (the
KV tiers' knobs and the batcher's chaos seams now run as the
reference's do); a
``tpu://`` run with no GPU exits 2; and the port's CLI runs with jax
blocked.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from adversarial_spec_tpu import cli as ref_cli
from adversarial_spec_tpu.debate import core as ref_core
from adversarial_spec_tpu.engine import dispatch as ref_dispatch
from adversarial_spec_tpu.resilience import breaker as ref_breaker
from adversarial_spec_tpu_torch import cli as port_cli
from adversarial_spec_tpu_torch.debate import core as port_core

from tests import torch_cli_support as sup

REPO = Path(__file__).resolve().parent.parent
SPEC = "# Cache Service\n\nA read-through cache."
E2E_SPEC = (
    "# Notification Service\n\nSends notifications to users over email "
    "and push.\n\n## Scope\nInitial version targets transactional "
    "messages only.\n"
)
E2E_MODELS = (
    "mock://agree,mock://critic?agree_after=2,mock://critic?agree_after=3,"
    "mock://flaky?fail=1&agree_after=2"
)


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture(autouse=True)
def _no_backoff(monkeypatch):
    """Retries back off 1 s then 2 s; both packages skip the sleep."""
    for core in (ref_core, port_core):
        monkeypatch.setattr(core.RoundConfig, "sleep", staticmethod(lambda s: None))


def _critique(*argv):
    return ("critique",) + argv


# Each case: a list of (argv, stdin) steps. "{files}" in an argument is
# replaced by a directory both packages read (diff / context inputs).
SCENARIOS = {
    "text_output": [(_critique("--models", "mock://agree,mock://critic"), SPEC)],
    "json_schema": [
        (_critique("--models", "mock://critic", "--json", "--doc-type", "tech"), SPEC)
    ],
    "all_agree_banner": [(_critique("--models", "mock://agree"), SPEC)],
    "empty_stdin": [(_critique(), "")],
    "unknown_provider": [(_critique("--models", "openai/gpt-4o"), SPEC)],
    "unknown_tpu_alias": [(_critique("--models", "tpu://nope"), SPEC)],
    "show_cost": [(_critique("--models", "mock://critic", "--show-cost"), SPEC)],
    "failed_model": [(_critique("--models", "mock://agree,mock://error"), SPEC)],
    "session_resume": [
        (
            _critique(
                "--models", "mock://critic", "--session", "s1",
                "--doc-type", "tech", "--focus", "security",
            ),
            SPEC,
        ),
        (_critique("--resume", "s1", "--json"), None),
        (("sessions",), None),
        (("sessions", "--json"), None),
    ],
    "info_actions": [
        (("focus-areas", "--json"), None),
        (("focus-areas",), None),
        (("personas", "--json"), None),
        (("personas",), None),
        (("providers",), None),
        (("profiles",), None),
        (("sessions",), None),
    ],
    "profiles": [
        (
            (
                "save-profile", "--name", "secfast", "--models", "mock://agree",
                "--focus", "security", "--doc-type", "prd",
                "--max-new-tokens", "64", "--temperature", "0.2",
            ),
            None,
        ),
        (_critique("--profile", "secfast", "--json"), SPEC),
        (_critique("--profile", "secfast", "--doc-type", "tech", "--json"), SPEC),
        (_critique("--profile", "ghost"), SPEC),
        (("profiles", "--json"), None),
        (("profiles",), None),
        (("save-profile",), None),
    ],
    "diff": [
        (("diff", "--previous", "{files}/a.md", "--current", "{files}/b.md"), None),
        (("diff",), None),
        (("diff", "--previous", "{files}/a.md", "--current", "{files}/none.md"), None),
    ],
    "export_tasks": [
        (("export-tasks", "--models", "mock://tasks", "--json"), SPEC),
        (("export-tasks", "--models", "mock://tasks"), SPEC),
        (("export-tasks", "--models", "mock://critic"), SPEC),
        (("export-tasks", "--models", "mock://error"), SPEC),
    ],
    "registry": [
        (("registry", "add-model", "mymodel", "--family", "mistral", "--size", "tiny"), None),
        (("registry", "add-model", "pq8", "--kv", "paged", "--kv-dtype", "int8"), None),
        (("registry", "alias", "judge", "mymodel"), None),
        (("registry", "alias", "judge", "mymodel"), None),
        (("registry", "alias", "x", "ghost"), None),
        (("registry", "list-models", "--json"), None),
        (("registry",), None),
        (("registry", "remove-model", "mymodel"), None),
        (("registry", "remove-model", "ghost"), None),
        (("registry", "explode"), None),
    ],
    "press_round": [
        (_critique("--models", "mock://agree,mock://agree", "--json"), E2E_SPEC),
        (
            _critique(
                "--models", "mock://agree,mock://agree", "--press",
                "--round", "1", "--json",
            ),
            E2E_SPEC,
        ),
    ],
    "resilience_report": [
        (_critique("--models", "mock://agree,mock://error", "--json"), SPEC),
    ],
    "breaker_across_invocations": [
        (
            _critique(
                "--models", "mock://error,mock://agree", "--json",
                "--session", "brk", "--breaker-threshold", "1",
                "--breaker-cooldown", "3600",
            ),
            SPEC,
        ),
        (_critique("--resume", "brk", "--json"), None),
        (_critique("--resume", "brk", "--json", "--no-breaker"), None),
    ],
    "flaky_retries": [
        (_critique("--models", "mock://flaky?fail=2", "--json"), SPEC),
        (_critique("--models", "mock://flaky?fail=5", "--json"), SPEC),
    ],
    "bad_chaos": [
        (_critique("--models", "mock://agree", "--chaos", "kaboom@generate"), SPEC),
    ],
    "journal_crash_seam": [
        (
            _critique(
                "--models", "mock://agree,mock://critic", "--session", "jc",
                "--chaos", "bug@crash:times=1", "--json",
            ),
            SPEC,
        ),
        (_critique("--resume", "jc", "--json", "--no-journal"), None),
    ],
    "knobs": [
        (
            _critique(
                "--models", "mock://critic,mock://agree", "--json",
                "--no-stream", "--no-speculative", "--no-prefix-cache",
            ),
            SPEC,
        ),
        (
            _critique(
                "--models", "mock://critic", "--json", "--gamma", "3",
                "--prefix-cache-pages", "4", "--no-early-cancel",
                "--no-interleave", "--no-kv-tier", "--no-fleet",
                "--pipeline-depth", "1",
            ),
            SPEC,
        ),
        (
            _critique(
                "--models", "mock://critic?agree_after=1&agree_tail=4&tps=64",
                "--json", "--persona", "security-engineer",
                "--preserve-intent", "--context", "{files}/a.md",
            ),
            SPEC,
        ),
        (_critique("--models", "mock://agree", "--context", "{files}/none.md"), SPEC),
        (_critique("--models", "mock://agree", "--no-obs", "--json"), SPEC),
    ],
    "events_and_metrics": [
        (
            _critique(
                "--models", "mock://agree,mock://critic", "--json",
                "--events-out", "{out}/events.jsonl",
                "--flight-recorder-size", "64",
                "--slo-ttft-ms", "1", "--slo-round-s", "0.01",
            ),
            SPEC,
        ),
    ],
    "notify_unconfigured": [
        (_critique("--models", "mock://agree", "--notify", "--json"), SPEC),
        (("send-final",), SPEC),
    ],
    "default_models": [(_critique("--json"), SPEC)],
    "e2e_converges": [
        (
            _critique(
                "--models", E2E_MODELS, "--doc-type", "tech",
                "--session", "e2e", "--json",
            ),
            E2E_SPEC,
        ),
        (_critique("--resume", "e2e", "--json"), None),
        (_critique("--resume", "e2e", "--json"), None),
        (_critique("--resume", "e2e", "--json"), None),
    ],
    "weight_res_off": [
        (_critique("--models", "mock://critic", "--json", "--no-weight-res"), SPEC),
        (("export-tasks", "--models", "mock://tasks", "--json", "--no-weight-res"), SPEC),
    ],
    "cost_across_rounds": [
        (_critique("--models", "mock://critic", "--round", "1", "--json"), E2E_SPEC),
        (_critique("--models", "mock://critic", "--round", "2", "--json"), E2E_SPEC),
    ],
}


def _run_scenario(pkg, steps, root, files, monkeypatch, capsys):
    """Every step of one scenario through one package's CLI, with that
    package's state under ``root``."""
    cli_mod = ref_cli if pkg == "ref" else port_cli
    sup.point_state(monkeypatch, pkg, root)
    out_dir = root / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(root)
    results = []
    for argv, stdin in steps:
        argv = [
            a.replace("{files}", str(files)).replace("{out}", str(out_dir))
            for a in argv
        ]
        code, out, err = sup.run_cli(cli_mod, argv, monkeypatch, capsys, stdin)
        results.append(
            (
                code,
                sup.normalize_stdout(out, pkg, root),
                sup.normalize_stderr(err, root),
            )
        )
    return results, sup.state_tree(root)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mock_scenario_matches_reference(name, tmp_path, monkeypatch, capsys):
    files = tmp_path / "files"
    files.mkdir()
    (files / "a.md").write_text("line one\n")
    (files / "b.md").write_text("line two\n")
    steps = SCENARIOS[name]
    ref, ref_files = _run_scenario(
        "ref", steps, tmp_path / "ref", files, monkeypatch, capsys
    )
    got, got_files = _run_scenario(
        "port", steps, tmp_path / "port", files, monkeypatch, capsys
    )
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g[0] == r[0], (i, g[2], r[2])
        assert g[1] == r[1], i
        assert g[2] == r[2], i
    assert got_files == ref_files
    # The scenarios exercise what they claim: at least one step ran a
    # round or an action that exited 0.
    assert any(r[0] == 0 for r in ref) or name in {
        "empty_stdin", "unknown_provider", "unknown_tpu_alias", "bad_chaos",
    }


def test_providers_json_matches_reference_but_the_device(monkeypatch, capsys):
    """``providers --json`` lists the same registry and mock models; its
    ``devices`` entry is each package's own device query."""
    ref = sup.run_cli(ref_cli, ["providers", "--json"], monkeypatch, capsys)
    got = sup.run_cli(port_cli, ["providers", "--json"], monkeypatch, capsys)
    assert ref[0] == got[0] == 0
    r, g = json.loads(ref[1]), json.loads(got[1])
    dev = g.pop("devices")
    r.pop("devices")
    assert g == r
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert dev["device_count"] == n
    assert dev["platform"] == ("gpu" if n else "none")


def test_session_started_by_reference_resumes_under_port(
    tmp_path, monkeypatch, capsys
):
    """Round 1 by the reference; round 2 by the reference and, from a
    copy of the same state, by the port, each as a fresh process would
    run it: the port's round 2 is the reference's, byte for byte (after
    the wall-clock fields), and so are the session files it leaves."""
    import shutil

    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    sup.point_state(monkeypatch, "ref", ref_root)
    monkeypatch.chdir(tmp_path)
    r1 = sup.run_cli(
        ref_cli,
        ["critique", "--models", E2E_MODELS, "--session", "x",
         "--doc-type", "prd", "--focus", "security", "--json"],
        monkeypatch, capsys, E2E_SPEC,
    )
    assert r1[0] == 0
    shutil.copytree(ref_root, port_root)
    # A new process each: no cached engine, breakers from the session.
    ref_dispatch.clear_engine_cache()
    ref_breaker.reset_default_registry()
    ref2 = sup.run_cli(
        ref_cli, ["critique", "--resume", "x", "--json"], monkeypatch, capsys
    )
    sup.point_state(monkeypatch, "port", port_root)
    got2 = sup.run_cli(
        port_cli, ["critique", "--resume", "x", "--json"], monkeypatch, capsys
    )
    assert ref2[0] == got2[0] == 0
    ref_doc = sup.normalize_stdout(ref2[1], "ref")
    got_doc = sup.normalize_stdout(got2[1], "port")
    assert got_doc == ref_doc
    assert got_doc["round"] == 2 and got_doc["focus"] == "security"
    assert [r["response"] for r in got_doc["results"]] == [
        r["response"] for r in ref_doc["results"]
    ]
    assert sup.state_tree(port_root) == sup.state_tree(ref_root)


REFUSED = {
    "pipeline_depth_2": (["critique", "--pipeline-depth", "2"], {}),
    "pipeline_depth_clamped": (["critique", "--pipeline-depth", "7"], {}),
    "pipeline_depth_env": (["critique"], {"ADVSPEC_PIPELINE_DEPTH": "2"}),
}

# Refused until the fleet was ported; accepted now, with the reference's
# exit code and report (``perf.fleet`` included; ``serve`` cases: the
# daemon's debate results and drain report).
FLEET_KNOBS = {
    "serve_fleet": (["serve", "--fleet-replicas", "2"], {}),
    "fleet": (["critique", "--fleet"], {}),
    "fleet_replicas": (["critique", "--fleet-replicas", "3"], {}),
    "fleet_transport": (["critique", "--fleet-transport", "worker"], {}),
    "fleet_autoscale": (["critique", "--fleet-autoscale"], {}),
    "fleet_min_max": (["critique", "--fleet-min", "1", "--fleet-max", "3"], {}),
    "fleet_prefill": (["critique", "--fleet-prefill-replicas", "1"], {}),
    "scale_knobs": (["critique", "--scale-cooldown-s", "1"], {}),
    "fleet_env": (["critique"], {"ADVSPEC_FLEET": "1"}),
    "fleet_replicas_env": (["critique"], {"ADVSPEC_FLEET_REPLICAS": "2"}),
    "chaos_replica_seam": (["critique", "--chaos", "bug@replica"], {}),
    "chaos_mixed": (["critique", "--chaos", "bug@crash,bug@replica"], {}),
    "export_tasks_fleet": (["export-tasks", "--fleet"], {}),
}

# Refused until the KV tiers and the batcher's chaos seams were ported;
# accepted now, with the reference's report. ``{store}`` is a directory
# under the test's ``tmp_path``.
TIER_AND_SEAM_KNOBS = {
    "kv_tier": (["critique", "--kv-tier"], {}),
    "kv_tier_env": (["critique"], {"ADVSPEC_KV_TIER": "1"}),
    "kv_store_dir": (["critique", "--kv-tier", "--kv-store-dir", "{store}"], {}),
    "kv_store_dir_env": (
        ["critique"], {"ADVSPEC_KV_TIER": "1", "ADVSPEC_KV_STORE_DIR": "{store}"}
    ),
    "kv_host_mb": (["critique", "--kv-tier", "--kv-host-mb", "64"], {}),
    "kv_flush_blocks": (["critique", "--kv-tier", "--kv-flush-blocks", "2"], {}),
    "chaos_engine_seam": (["critique", "--chaos", "oom@scheduler_chunk"], {}),
    "chaos_generate_env": (["critique"], {"ADVSPEC_CHAOS": "bug@generate"}),
    "chaos_batcher_seams": (
        ["critique", "--chaos", "bug@crash,oom@kv_alloc,bug@kv_swap"], {}
    ),
}


# Refused until GpuEngine's weight residency was ported; accepted now,
# with the reference's report.
ACCEPTED_NOW = {
    "weight_res": (["critique", "--weight-res"], {}),
    "weight_host_mb": (["critique", "--weight-host-mb", "64"], {}),
    "weight_res_env": (["critique"], {"ADVSPEC_WEIGHT_RES": "1"}),
    "weight_host_mb_env": (["critique"], {"ADVSPEC_WEIGHT_HOST_MB": "64"}),
    "weight_swap_chaos": (["critique", "--chaos", "oom@weight_swap"], {}),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED_NOW))
def test_weight_residency_knob_matches_reference(name, tmp_path, monkeypatch, capsys):
    argv, env = ACCEPTED_NOW[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    docs = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg)
        code, out, err = sup.run_cli(
            cli_mod, argv + ["--models", "mock://critic", "--json"], monkeypatch, capsys, SPEC
        )
        assert code == 0, err
        docs.append(sup.normalize_report(json.loads(out), pkg))
    assert docs[1] == docs[0]
    weights = docs[1]["perf"]["weights"]
    assert weights["enabled"] is True
    assert weights["host_mb"] == (64 if "host_mb" in name else 2048)


@pytest.mark.parametrize("name", sorted(TIER_AND_SEAM_KNOBS))
def test_tier_and_seam_knob_matches_reference(name, tmp_path, monkeypatch, capsys):
    """The KV tiers' flags and env vars and the engine's chaos seams run
    the round as the reference does: the same exit code and report
    (``perf.kv_tier`` included; the mock drives the tiers' state
    machine), and the same disk-store entries when a store is armed."""
    argv, env = TIER_AND_SEAM_KNOBS[name]
    docs, stores = [], []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        store = tmp_path / pkg / "kv"
        stores.append(store)
        for k, v in env.items():
            monkeypatch.setenv(k, v.format(store=store))
        sup.point_state(monkeypatch, pkg, tmp_path / pkg)
        code, out, err = sup.run_cli(
            cli_mod,
            [a.format(store=store) for a in argv]
            + ["--models", "mock://critic,mock://critic", "--json"],
            monkeypatch, capsys, E2E_SPEC * 6,
        )
        assert code == 0, err
        doc = sup.normalize_report(json.loads(out), pkg)
        for field in ("store_dir", "swap_in_s", "swap_out_s"):  # paths, walls
            doc["perf"]["kv_tier"].pop(field)
        docs.append(doc)
    assert docs[1] == docs[0]
    tier = docs[1]["perf"]["kv_tier"]
    assert tier["enabled"] is ("kv_" in name)
    if "store_dir" in name:
        assert tier["store_writes"] > 0
        assert sup.state_tree(stores[1]) == sup.state_tree(stores[0])


def _serve_one_debate(cli_mod, argv, sock, monkeypatch, capsys):
    """``serve`` through ``cli_mod.main`` on a thread: one streamed mock
    debate over the socket, then a drain. (exit code, results, drain
    report's counters)."""
    import threading

    client_mod = (
        "adversarial_spec_tpu.serve.client"
        if cli_mod is ref_cli
        else "adversarial_spec_tpu_torch.serve.client"
    )
    ServeClient = __import__(client_mod, fromlist=["ServeClient"]).ServeClient
    box = {}
    th = threading.Thread(
        target=lambda: box.update(code=cli_mod.main(argv + ["--socket", str(sock)])),
        daemon=True,
    )
    th.start()
    deadline = time.monotonic() + 20
    while not sock.exists():
        assert th.is_alive() and time.monotonic() < deadline, "daemon did not come up"
        time.sleep(0.02)
    client = ServeClient(str(sock), timeout_s=20)
    try:
        rid = client.submit_debate(SPEC, ["mock://critic", "mock://agree"], stream=True)
        results = client.collect(rid, timeout_s=20)[-1]["results"]
        client.drain()
    finally:
        client.close()
    th.join(timeout=20)
    assert not th.is_alive()
    out, _ = capsys.readouterr()
    report = json.loads(out.strip().splitlines()[-1])
    assert report["event"] == "drain_report"
    return box["code"], results, report["stats"]


@pytest.mark.parametrize("name", sorted(FLEET_KNOBS))
def test_fleet_knob_matches_reference(name, tmp_path, monkeypatch, capsys):
    """The fleet's flags, env vars and chaos seam run as the reference's
    do: the same exit code and ``--json`` report (``perf.fleet``
    included) for ``critique`` and ``export-tasks``, and for ``serve``
    the same debate results and drain counters."""
    argv, env = FLEET_KNOBS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for pkg, cli_mod in (("ref", ref_cli), ("port", port_cli)):
        sup.point_state(monkeypatch, pkg, tmp_path / pkg)
        if argv[0] == "serve":
            got.append(_serve_one_debate(
                cli_mod, argv, tmp_path / f"{pkg}.sock", monkeypatch, capsys
            ))
            continue
        models = "mock://tasks" if argv[0] == "export-tasks" else "mock://critic,mock://agree"
        code, out, err = sup.run_cli(
            cli_mod, argv + ["--models", models, "--json"], monkeypatch, capsys, SPEC
        )
        assert code == 0, err
        got.append((code, sup.normalize_stdout(out, pkg)))
    assert got[1] == got[0]
    if name in ("fleet_replicas", "fleet_prefill", "fleet_env"):
        # These arm a routed fleet only with ``--fleet``/``ADVSPEC_FLEET``.
        fleet = got[1][1]["perf"]["fleet"]
        assert fleet["enabled"] is (name == "fleet_env")


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_knob_exits_2(name, monkeypatch, capsys):
    argv, env = REFUSED[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    code, out, err = sup.run_cli(
        port_cli, argv + ["--models", "mock://agree"], monkeypatch, capsys, SPEC
    )
    assert code == 2, err
    assert "not yet ported" in err
    assert out == ""


def _serve_flags(help_text: str) -> set[str]:
    section = help_text.split("\nserve:\n", 1)[1].split("\n\n", 1)[0]
    return {w for w in section.split() if w.startswith("--")}


def test_serve_action_is_served(tmp_path, monkeypatch, capsys):
    """Refused until the serve daemon was ported. ``serve --help`` lists
    the reference's serve flags, and ``serve`` runs the port's daemon:
    it answers ``ping`` over its socket and exits 0 after a ``drain``."""
    import threading

    from adversarial_spec_tpu_torch.serve.client import ServeClient

    helps = []
    for cli_mod in (ref_cli, port_cli):
        code, out, _ = sup.run_cli(cli_mod, ["serve", "--help"], monkeypatch, capsys)
        assert code == 0
        helps.append(_serve_flags(out))
    assert helps[1] == helps[0]
    assert {"--socket", "--serve-drain-deadline-s", "--drain-report"} <= helps[1]

    sock = tmp_path / "s.sock"
    box = {}
    th = threading.Thread(
        target=lambda: box.update(code=port_cli.main(["serve", "--socket", str(sock)])),
        daemon=True,
    )
    th.start()
    deadline = time.monotonic() + 20
    while not sock.exists():
        assert th.is_alive() and time.monotonic() < deadline, "daemon did not come up"
        time.sleep(0.02)
    client = ServeClient(str(sock), timeout_s=20)
    try:
        pong = client.ping()
        assert pong["event"] == "pong" and pong["draining"] is False
        assert client.drain()["event"] == "ok"
    finally:
        client.close()
    th.join(timeout=20)
    assert not th.is_alive() and box["code"] == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["event"] == "drain_report"
    assert "advspec serve: listening on" in err


def test_ported_chaos_seam_and_off_switches_pass(monkeypatch, capsys):
    """The journal's ``crash`` seam is ported, depth 1 is what the port
    does anyway, and the off switches of what it has (``--no-kv-tier``,
    ``ADVSPEC_KV_TIER=0``, ``--no-fleet``, ``ADVSPEC_FLEET=0``,
    ``ADVSPEC_WEIGHT_RES=0``) turn them off."""
    monkeypatch.setenv("ADVSPEC_KV_TIER", "0")
    monkeypatch.setenv("ADVSPEC_FLEET", "0")
    monkeypatch.setenv("ADVSPEC_WEIGHT_RES", "0")
    code, out, err = sup.run_cli(
        port_cli,
        ["critique", "--models", "mock://agree", "--json", "--no-kv-tier",
         "--no-fleet", "--pipeline-depth", "1", "--chaos", "bug@crash"],
        monkeypatch, capsys, SPEC,
    )
    assert code == 0, err
    perf = json.loads(out)["perf"]
    assert perf["kv_tier"]["enabled"] is False
    assert perf["interleave"]["pipeline_depth"] == 1
    assert perf["fleet"]["enabled"] is False
    assert perf["fleet"]["routed_requests"] == 0
    assert perf["weights"]["enabled"] is False


def test_tpu_critique_without_gpu_exits_2(monkeypatch, capsys):
    """No engine installed and no GPU: validation names the missing
    device, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tpu:// serves on it")
    code, out, err = sup.run_cli(
        port_cli, ["critique", "--models", "tpu://random-tiny", "--json"],
        monkeypatch, capsys, SPEC,
    )
    assert code == 2
    assert "no CUDA device is available" in err
    assert out == ""
    from adversarial_spec_tpu_torch.engine import dispatch

    assert dispatch.cached_engines() == []


def test_unservable_alias_exits_2_before_the_round(tmp_path, monkeypatch, capsys):
    """The mesh aliases once refused at validation ("not yet ported", exit
    2) run their round as the reference's CLI runs them. A {"tp": 2,
    "sp": 2} alias (dp=2 × sp=2 × tp=2 over 8 devices) on the reference's
    weights: ``critique --json`` equal to the reference CLI's. A tp that
    does not divide the KV heads: the same exit code and ``--json``, each
    opponent's error the reference's ``ValueError`` (JAX words its
    sharding, the port its own: masked to the shared phrase)."""
    import jax
    import numpy as np

    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.loader import params_from_jax
    from adversarial_spec_tpu_torch.parallel.sharding import shard_params

    phrase = "implies that array axis 2 is partitioned 4 times, but the dimension size is 2"
    for spec in (
        registry.ModelSpec(alias="meshy", dtype="float32", mesh={"tp": 2, "sp": 2}),
        registry.ModelSpec(alias="tp4", mesh={"dp": 2, "tp": 4}),
    ):
        registry.save_registry_entry(spec, tmp_path / "registry.json")
    lm = ref_dispatch.get_engine("tpu://meshy")._load("meshy")
    port = GpuEngine(device="cpu", devices=["cpu"] * 8)
    spec = registry.resolve_model_spec("tpu://meshy")
    params = params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32)
    port.install("meshy", shard_params(port.mesh_for(spec), params))
    dispatch.install_engine("tpu://meshy", port)

    def masked(doc, pkg):
        for r in doc["results"]:
            if r["error"] is not None:
                assert r["error"].startswith("ValueError: ") and phrase in r["error"]
                r["error"] = phrase
        return sup.without_walls(sup.normalize_report(doc, pkg))

    for models, n_ok in (("tpu://meshy,tpu://meshy", 2), ("tpu://tp4", 0)):
        argv = ["critique", "--models", models, "--greedy", "--max-new-tokens", "12", "--json"]
        (rc, rout, rerr), (pc, pout, perr) = sup.both_cli(argv, tmp_path, monkeypatch, capsys, SPEC)
        assert pc == rc, (rerr, perr)
        assert "not yet ported" not in perr
        ref, got = json.loads(rout), json.loads(pout)
        assert [r["error"] is None for r in got["results"]].count(True) == n_ok
        assert masked(got, "port") == masked(ref, "ref")


def test_default_models_pick_an_hf_alias_as_the_reference_does(tmp_path, monkeypatch):
    """With no ``--models``, both CLIs pick the same opponent: the largest
    registry alias whose checkpoint directory exists (an HF alias is now
    served by the port), else the mock critic."""
    from adversarial_spec_tpu.engine import registry as ref_registry
    from adversarial_spec_tpu_torch.engine import registry

    reg = tmp_path / "shared-registry.json"
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", reg)
    monkeypatch.setattr(registry, "REGISTRY_PATH", reg)
    assert port_cli.get_default_models() == ref_cli.get_default_models()
    assert port_cli.get_default_models() == ["mock://critic?agree_after=3"]
    for alias, size, exists in (
        ("tiny-hf", "tiny", True), ("big-gone", "70b", False), ("mid-hf", "8b", True),
        ("small-hf", "1b", True),
    ):
        ckpt = tmp_path / alias
        if exists:
            ckpt.mkdir()
        registry.save_registry_entry(
            registry.ModelSpec(alias=alias, size=size, checkpoint=str(ckpt))
        )
        assert port_cli.get_default_models() == ref_cli.get_default_models()
    assert port_cli.get_default_models() == ["tpu://mid-hf"]


def test_port_cli_runs_with_jax_blocked(tmp_path):
    """``critique --models mock://agree --json`` through the port in a
    process where ``import jax`` and the reference package fail."""
    code = (
        "import sys, io\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['adversarial_spec_tpu'] = None\n"
        "sys.stdin = io.StringIO('# Spec\\nBody.')\n"
        "from adversarial_spec_tpu_torch import cli\n"
        "rc = cli.main(['critique', '--models', 'mock://agree', '--json'])\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "sys.exit(rc)\n"
    )
    env = {
        "PATH": "/usr/bin:/bin",
        "HOME": str(tmp_path),
        "ADVSPEC_SESSIONS_DIR": str(tmp_path / "sessions"),
        "PYTHONPATH": str(REPO),
    }
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout)
    assert doc["all_agreed"] is True
    assert doc["results"][0]["model"] == "mock://agree"


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path, monkeypatch, capsys):
    """``--profile-dir`` traces the round with torch.profiler (the
    reference's jax.profiler trace) into a Chrome trace in that dir."""
    out_dir = tmp_path / "prof"
    code, out, err = sup.run_cli(
        port_cli,
        ["critique", "--models", "mock://agree", "--json", "--profile-dir",
         str(out_dir)],
        monkeypatch, capsys, SPEC,
    )
    assert code == 0, err
    trace = json.loads((out_dir / "trace.json").read_text())
    assert "traceEvents" in trace
    assert json.loads(out)["all_agreed"] is True
