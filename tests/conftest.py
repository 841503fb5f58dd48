"""Shared pytest harness for tpu-feature-discovery.

Tier map (SURVEY.md section 4):
  tier 1 - C++ unit tests (build/tfd_unit_tests, run via test_unit_cpp.py)
  tier 2 - process-level tests: run the real binary with the mock backend and
           validate output against golden regex files (the checkResult
           analogue, reference cmd/gpu-feature-discovery/main_test.go:403-435)
  tier 3 - hermetic integration: fake GCE metadata server + metadata backend
  (tier 4, real-cluster e2e, lives in deployments/ and is not run here)

JAX-based tests (tpufd package) run on a virtual 8-device CPU mesh.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
# Make the tpufd package (fakes, health, mesh) importable from every test
# module — the single home of this path patch.
sys.path.insert(0, str(REPO))
# TFD_BUILD_DIR lets `make coverage` point every tier at the
# gcov-instrumented build, so process-level/golden/e2e paths count
# toward coverage, not just the unit suite.
BUILD_DIR = Path(os.environ.get("TFD_BUILD_DIR", REPO / "build"))
if not BUILD_DIR.is_absolute():
    BUILD_DIR = REPO / BUILD_DIR
BINARY = BUILD_DIR / "tpu-feature-discovery"
UNIT_TESTS = BUILD_DIR / "tfd_unit_tests"
FIXTURES = Path(__file__).resolve().parent / "fixtures"
GOLDEN = Path(__file__).resolve().parent / "golden"

# Virtual 8-device CPU mesh for sharding tests (the driver dry-runs
# multi-chip separately via __graft_entry__.dryrun_multichip). The
# environment may pin JAX_PLATFORMS to a hardware plugin that overrides the
# env var, so tests that import jax must ALSO call
# jax.config.update("jax_platforms", "cpu") before first device use — the
# `cpu_jax` fixture below does both.
os.environ["JAX_PLATFORMS"] = "cpu"
# The pre-ISSUE-12 battery is cadence-shaped: it counts passes per
# sleep-interval, watches the label-file mtime advance, and waits for
# the Nth rewrite. Those contracts live on behind --event-driven=false
# (the legacy interval loop, fully supported for bisection), so the
# whole battery pins it via the env default here; the event core's own
# battery (tests/test_watch.py, the watch/SSA suites in test_fleet.py)
# opts back in explicitly with the CLI flag, which beats this env.
os.environ.setdefault("TFD_EVENT_DRIVEN", "false")
if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-wall-clock drills (multi-minute waits, redundant "
        "with a soak or a cheaper sibling) excluded from the tier-1 "
        "budget's `-m 'not slow'` run; CI's dedicated soak steps and a "
        "`-m slow` run still cover them")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def cpu_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()}")
    return jax


def _gxx_build():
    """Plain-g++ fallback for environments without cmake/ninja: compiles
    the tfd_core source list straight out of CMakeLists.txt and links the
    same artifacts the CMake build produces (daemon, unit tests, fake
    PJRT plugin, standalone-driver fuzzers)."""
    import re
    import shutil

    obj_dir = BUILD_DIR / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    version = (REPO / "VERSION").read_text().strip()
    commit = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
        capture_output=True, text=True).stdout.strip() or "unknown"
    common = ["g++", "-std=c++17", "-O1", f"-I{REPO}/src",
              f"-I{REPO}/third_party"]
    defines = [f"-DTFD_VERSION=\"{version}\"",
               f"-DTFD_GIT_COMMIT=\"{commit}\""]
    cmake_text = (REPO / "CMakeLists.txt").read_text()
    core_sources = re.findall(r"^\s+(src/tfd/\S+\.cc)$", cmake_text,
                              re.MULTILINE)
    core_sources = [s for s in core_sources
                    if "tests/" not in s and "testing/" not in s]
    # Compile in parallel (the tier-1 time budget pays for every serial
    # second here); each job is independent, the links below are not.
    from concurrent.futures import ThreadPoolExecutor

    objects = []
    jobs = []
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        for src in core_sources:
            obj = obj_dir / (src.replace("/", "_") + ".o")
            objects.append(str(obj))
            jobs.append(pool.submit(
                subprocess.run, [*common, *defines, "-c", str(REPO / src),
                                 "-o", str(obj)],
                check=True, capture_output=True))
        for job in jobs:
            job.result()  # re-raises the first compile failure
    link = ["-ldl", "-lpthread"]
    subprocess.run([*common, *defines,
                    str(REPO / "cmd/tpu-feature-discovery/main.cc"),
                    *objects, "-o", str(BINARY), *link],
                   check=True, capture_output=True)
    subprocess.run([*common, str(REPO / "src/tfd/tests/unit_tests.cc"),
                    *objects, "-o", str(UNIT_TESTS), *link],
                   check=True, capture_output=True)
    subprocess.run([*common, "-shared", "-fPIC",
                    str(REPO / "src/tfd/testing/fake_pjrt.cc"),
                    "-o", str(BUILD_DIR / "libtfd_fake_pjrt.so")],
                   check=True, capture_output=True)
    driver = REPO / "src/tfd/tests/fuzz/standalone_driver.cc"
    for target in sorted(set(re.findall(r"\bfuzz_[a-z]+\b", cmake_text))):
        subprocess.run(
            [*common, str(REPO / f"src/tfd/tests/fuzz/{target}.cc"),
             str(driver), *objects, "-o", str(BUILD_DIR / target), *link],
            check=True, capture_output=True)


def _build():
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        _gxx_build()
        return
    subprocess.run(
        ["cmake", "-S", str(REPO), "-B", str(BUILD_DIR), "-G", "Ninja"],
        check=True, capture_output=True)
    subprocess.run(["ninja", "-C", str(BUILD_DIR)], check=True,
                   capture_output=True)


def _binaries_stale():
    """True when any C++ source/header (or CMakeLists.txt) is newer than
    the built artifacts — an exists()-only check once let a whole tier-1
    run silently validate a binary predating the edits under test."""
    targets = [BINARY, UNIT_TESTS]
    if any(not t.exists() for t in targets):
        return True
    built = min(t.stat().st_mtime for t in targets)
    sources = [REPO / "CMakeLists.txt",
               REPO / "cmd/tpu-feature-discovery/main.cc"]
    for pattern in ("*.cc", "*.h"):
        sources.extend((REPO / "src/tfd").rglob(pattern))
    return any(s.stat().st_mtime > built for s in sources if s.exists())


@pytest.fixture(scope="session")
def tfd_binary():
    if _binaries_stale():
        _build()
    return BINARY


@pytest.fixture(scope="session")
def unit_test_binary():
    if _binaries_stale():
        _build()
    return UNIT_TESTS


def run_tfd(binary, args, env=None, timeout=60):
    """Runs the binary; returns (exit_code, stdout, stderr)."""
    full_env = dict(os.environ)
    # Isolate from any real GCE metadata reachable from CI.
    full_env.setdefault("GCE_METADATA_HOST", "127.0.0.1:1")
    if env:
        full_env.update(env)
    proc = subprocess.run(
        [str(binary)] + args, capture_output=True, text=True,
        timeout=timeout, env=full_env)
    return proc.returncode, proc.stdout, proc.stderr


def check_golden(output: str, golden_file: Path):
    """Every output line must match one of the golden regexes, and every
    golden regex must match at least one line (reference checkResult is
    line→regex only; we additionally require full coverage so missing labels
    fail). Shared matcher: tests/golden_match.py."""
    from golden_match import load_golden, match_lines

    lines = [l for l in output.splitlines() if l.strip()]
    unmatched_lines, unmatched_regexes = match_lines(
        load_golden(golden_file), lines)
    assert not unmatched_lines, (
        f"output lines not matched by any golden regex in "
        f"{golden_file.name}: {unmatched_lines}")
    assert not unmatched_regexes, (
        f"golden regexes with no matching output line in "
        f"{golden_file.name}: "
        f"{[r.pattern for r in unmatched_regexes]}")


def labels_of(output: str):
    """Parses `key=value` label lines into a dict."""
    return dict(line.split("=", 1) for line in output.splitlines() if line)


# ---- introspection-server test helpers (shared by test_introspection,
# test_sched, test_journal — one home, so the daemon-driving idiom and
# its timeouts cannot drift between files) ----------------------------------

def http_get(port, path, timeout=2):
    """(status, body); (None, "") while the server is unreachable —
    polling callers ride through startup and SIGHUP-rebind windows."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except (OSError, urllib.error.URLError):
        return None, ""


def wait_for(predicate, timeout=30, interval=0.05):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def daemon_argv(binary, port, out_file, extra=()):
    """Standard daemon-under-test invocation: mock backend, 1s cadence,
    introspection pinned to a loopback port."""
    return [str(binary), "--sleep-interval=1s", "--backend=mock",
            f"--mock-topology-file={FIXTURES / 'v2-8.yaml'}",
            "--machine-type-file=/dev/null",
            f"--output-file={out_file}",
            f"--introspection-addr=127.0.0.1:{port}", *extra]
