"""The port's fake GCE metadata server against the reference's: the
metadata constructors (`tpu_vm`, `v5p_128_worker3`, `gke_tpu_node`,
`cpu_vm`) on arguments drawn from a numpy seed give equal dicts, and the
same GET sequence against each package's `FakeMetadataServer` (with and
without the Metadata-Flavor header, unknown keys, a live data swap)
gives the same statuses, headers and bodies."""

import http.client

import numpy as np
import pytest

from tpufd.fakes import metadata_server as ref
from tpufd_torch.fakes import metadata_server


def tpu_vm_kwargs(rng):
    pick = lambda *options: options[int(rng.integers(len(options)))]  # noqa
    kwargs = {
        "accelerator_type": pick("v5litepod-4", "v5p-128", "v4-8",
                                 "v6e-256"),
        "topology": pick(None, "2x2", "4x4x4"),
        "worker_id": int(rng.integers(0, 16)),
        "chips_per_host_bounds": pick(None, "2,2,1"),
        "host_bounds": pick(None, "2,2,4", "1,1,1"),
        "machine_type": pick("ct5lp-hightpu-4t", "ct5p-hightpu-4t"),
        "preemptible": bool(rng.integers(2)),
        "preempted": bool(rng.integers(2)),
        "spot": bool(rng.integers(2)),
        "zone": pick("us-central2-b", "europe-west4-a"),
        "megascale_slice_id": pick(None, 0, 3),
        "megascale_num_slices": pick(None, 2, 4),
        "instance_id": str(int(rng.integers(10 ** 9))),
        "extra_attributes": pick(None, {"tpu-name": "x", "k": "v"}),
        "include_worker_id": bool(rng.integers(2)),
        "hostname": pick(None, "t1v-n-0-w-0"),
        "tpu_name": pick(None, "my-tpu"),
        "runtime_version": pick("tpu-ubuntu2204-base", ""),
    }
    if rng.integers(2):
        kwargs["agent_bootstrap_image"] = pick("", "gcr.io/x:y")
    return {k: v for k, v in kwargs.items() if rng.random() < 0.8}


@pytest.mark.parametrize("seed", range(3))
def test_metadata_dicts_equal(seed):
    rng = np.random.default_rng(2400 + seed)
    for _ in range(200):
        kwargs = tpu_vm_kwargs(rng)
        assert metadata_server.tpu_vm(**kwargs) == ref.tpu_vm(**kwargs)
        overrides = {k: kwargs[k] for k in ("worker_id", "zone", "spot")
                     if k in kwargs}
        assert metadata_server.v5p_128_worker3(**overrides) == \
            ref.v5p_128_worker3(**overrides)
        gke = {"machine_type": kwargs.get("machine_type", "ct5lp"),
               "gke_accelerator": str(rng.choice(["", "tpu-v5p-slice"])),
               "gke_topology": str(rng.choice(["", "2x2x2"])),
               "extra_kube_labels": ({"a": "1"} if rng.integers(2)
                                     else None),
               "agent_worker_number": (None if rng.integers(2)
                                       else int(rng.integers(4))),
               "hostname": kwargs.get("hostname")}
        assert metadata_server.gke_tpu_node(**gke) == ref.gke_tpu_node(**gke)
    assert metadata_server.cpu_vm() == ref.cpu_vm()
    assert metadata_server.cpu_vm("e2-small") == ref.cpu_vm("e2-small")


def get(endpoint, path, flavor=True):
    host, port = endpoint.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    conn.request("GET", path,
                 headers={"Metadata-Flavor": "Google"} if flavor else {})
    resp = conn.getresponse()
    out = (resp.status, resp.headers.get("Metadata-Flavor"),
           resp.headers.get("Content-Length"), resp.read())
    conn.close()
    return out


def serve(module):
    data = module.v5p_128_worker3(tpu_name="slice-a")
    answers = []
    with module.FakeMetadataServer(data) as server:
        for key in list(data) + ["instance/nope", ""]:
            answers.append(get(server.endpoint, f"/computeMetadata/v1/{key}"))
        answers.append(get(server.endpoint,
                           "/computeMetadata/v1/instance/id", flavor=False))
        answers.append(get(server.endpoint, "/other/instance/id"))
        server.set_data(module.cpu_vm())
        answers.append(get(server.endpoint,
                           "/computeMetadata/v1/instance/machine-type"))
        answers.append(get(server.endpoint,
                           "/computeMetadata/v1/instance/attributes/tpu-env"))
    return answers


def test_servers_answer_alike():
    got, want = serve(metadata_server), serve(ref)
    assert got == want
    assert {status for status, *_ in got} == {200, 403, 404}
