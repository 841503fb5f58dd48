"""The port's own copy of ``tpufd.fakes.metadata_server``
(``tpufd/fakes/metadata_server.py``), kept equal to it and importing
nothing of ``tpufd``.

A fake GCE instance-metadata server for hermetic TPU-VM tests.

The reference's integration tier needs a real cloud GPU node
(tests/integration-tests.py + Terraform); SURVEY.md section 4 flags the
missing hermetic multi-host harness as the thing to improve. This fake
serves the exact metadata keys the daemon's metadata backend and machine-
type labeler read, so BASELINE configs 2-5 run as plain pytest.

Usage:
    with FakeMetadataServer(tpu_vm(accelerator_type="v5p-128",
                                   worker_id=3)) as server:
        run_binary(["--backend=metadata",
                    f"--metadata-endpoint=127.0.0.1:{server.port}"])
"""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def tpu_vm(accelerator_type="v5litepod-4", topology=None, worker_id=0,
           chips_per_host_bounds=None, host_bounds=None,
           machine_type="ct5lp-hightpu-4t", preemptible=False,
           preempted=False,
           spot=False, zone="us-central2-b", megascale_slice_id=None,
           megascale_num_slices=None, instance_id="1234567890",
           extra_attributes=None, include_worker_id=True, hostname=None,
           tpu_name=None,
           runtime_version="tpu-ubuntu2204-base",
           agent_bootstrap_image=(
               "gcr.io/cloud-tpu-v2-images/grpc_tpu_worker:cl_20240321")):
    """Builds the metadata key->value dict for a TPU VM.

    Keys mirror real TPU-VM metadata: instance/machine-type,
    instance/attributes/accelerator-type, and the tpu-env bag with
    ACCELERATOR_TYPE / TOPOLOGY / CHIPS_PER_HOST_BOUNDS / HOST_BOUNDS /
    WORKER_ID entries (values single-quoted, as the real agent writes them).
    """
    tpu_env_lines = [f"ACCELERATOR_TYPE: '{accelerator_type}'"]
    if tpu_name:
        # The slice-coherence layer derives its deterministic slice id
        # from this (every member of a slice shares the TPU name).
        tpu_env_lines.append(f"TPU_NAME: '{tpu_name}'")
    if runtime_version:
        tpu_env_lines.append(f"RUNTIME_VERSION: '{runtime_version}'")
    if agent_bootstrap_image:
        tpu_env_lines.append(
            f"AGENT_BOOTSTRAP_IMAGE: '{agent_bootstrap_image}'")
    if topology:
        tpu_env_lines.append(f"TOPOLOGY: '{topology}'")
    if chips_per_host_bounds:
        tpu_env_lines.append(
            f"CHIPS_PER_HOST_BOUNDS: '{chips_per_host_bounds}'")
    if host_bounds:
        tpu_env_lines.append(f"HOST_BOUNDS: '{host_bounds}'")
    if include_worker_id:
        # Some TPU runtime agents rewrite tpu-env without WORKER_ID; the
        # daemon then falls back to agent-worker-number / the hostname.
        tpu_env_lines.append(f"WORKER_ID: '{worker_id}'")
    if megascale_slice_id is not None:
        tpu_env_lines.append(f"MEGASCALE_SLICE_ID: '{megascale_slice_id}'")
    if megascale_num_slices is not None:
        tpu_env_lines.append(
            f"MEGASCALE_NUM_SLICES: '{megascale_num_slices}'")
    data = {
        "instance/id": instance_id,
        "instance/machine-type":
            f"projects/12345/machineTypes/{machine_type}",
        "instance/zone": f"projects/12345/zones/{zone}",
        "instance/scheduling/preemptible":
            "TRUE" if preemptible else "FALSE",
        "instance/scheduling/provisioning-model":
            "SPOT" if spot else "STANDARD",
        # instance/preempted flips to TRUE when GCE sends the
        # preemption notice — the lifecycle probe's fast-path input
        # (flip it live via FakeMetadataServer.set_data).
        "instance/preempted": "TRUE" if preempted else "FALSE",
        "instance/attributes/accelerator-type": accelerator_type,
        "instance/attributes/tpu-env": "\n".join(tpu_env_lines) + "\n",
        "instance/attributes/agent-worker-number": str(worker_id),
    }
    if hostname:
        data["instance/hostname"] = hostname
    if extra_attributes:
        for key, value in extra_attributes.items():
            data[f"instance/attributes/{key}"] = value
    return data


def v5p_128_worker3(**overrides):
    """The canonical BASELINE config-4 host: worker 3 of a v5p-128 slice
    (4x4x4, 16 hosts), as several tests and goldens pin it. Keyword
    overrides replace individual fields."""
    spec = dict(
        accelerator_type="v5p-128", topology="4x4x4",
        chips_per_host_bounds="2,2,1", host_bounds="2,2,4",
        worker_id=3, machine_type="ct5p-hightpu-4t")
    spec.update(overrides)
    return tpu_vm(**spec)


def gke_tpu_node(machine_type="ct5lp-hightpu-4t",
                 gke_accelerator="tpu-v5-lite-podslice",
                 gke_topology="4x4", cluster_name="tpu-cluster",
                 zone="us-west4-a", extra_kube_labels=None,
                 agent_worker_number=None, hostname=None):
    """Metadata for a GKE TPU node-pool node.

    GKE TPU nodes do NOT carry the Cloud-TPU-VM attributes
    (accelerator-type / tpu-env); their TPU identity is the ct* machine
    type plus the node labels the node pool was created with
    (cloud.google.com/gke-tpu-accelerator, gke-tpu-topology), which GCE
    surfaces through the kube-labels instance attribute. GKE-specific
    attributes like kube-env and cluster-name are present instead.
    """
    labels = {
        "cloud.google.com/gke-nodepool": "tpu-pool",
    }
    if gke_accelerator:
        labels["cloud.google.com/gke-tpu-accelerator"] = gke_accelerator
    if gke_topology:
        labels["cloud.google.com/gke-tpu-topology"] = gke_topology
    if extra_kube_labels:
        labels.update(extra_kube_labels)
    data = {
        "instance/id": "5555555555",
        "instance/machine-type":
            f"projects/12345/machineTypes/{machine_type}",
        "instance/zone": f"projects/12345/zones/{zone}",
        "instance/scheduling/preemptible": "FALSE",
        "instance/scheduling/provisioning-model": "STANDARD",
        "instance/attributes/cluster-name": cluster_name,
        "instance/attributes/kube-env": "AUTOSCALER_ENV_VARS: ...\n",
        "instance/attributes/kube-labels":
            ",".join(f"{k}={v}" for k, v in sorted(labels.items())),
    }
    if agent_worker_number is not None:
        data["instance/attributes/agent-worker-number"] = str(
            agent_worker_number)
    if hostname:
        data["instance/hostname"] = hostname
    return data


def cpu_vm(machine_type="n2-standard-8"):
    """Metadata for a plain (non-TPU) GCE VM."""
    return {
        "instance/id": "987654321",
        "instance/machine-type":
            f"projects/12345/machineTypes/{machine_type}",
        "instance/scheduling/preemptible": "FALSE",
    }


class _Handler(BaseHTTPRequestHandler):
    data = {}

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.headers.get("Metadata-Flavor") != "Google":
            self.send_response(403)
            self.end_headers()
            return
        prefix = "/computeMetadata/v1/"
        if not self.path.startswith(prefix):
            self.send_response(404)
            self.end_headers()
            return
        key = self.path[len(prefix):]
        if key in self.data:
            body = self.data[key].encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Metadata-Flavor", "Google")
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, *args):  # silence request logging in tests
        pass


class FakeMetadataServer:
    def __init__(self, data, port=0):
        self._handler = type("Handler", (_Handler,), {"data": dict(data)})
        self._server = ThreadingHTTPServer(("127.0.0.1", port),
                                           self._handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def set_data(self, data):
        """Swaps the served metadata live — for tests that model a
        metadata server recovering (or changing) mid-daemon-run."""
        self._handler.data = dict(data)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        return False

    @property
    def endpoint(self):
        return f"127.0.0.1:{self.port}"
