"""The real daemon's fleet modes on the CPU against the port's fake
apiserver and held to the port's twins, through the functions
chip_smoke.py phase 9 runs on the card. A node CR shaped like the card's
(the labels and annotations its daemon publishes there) and the three
seeded peers go into `tpufd_torch.fakes.apiserver.FakeApiServer`; then:

  - --mode=aggregator: the tfd-cluster-inventory CR's labels equal
    `tpufd_torch.agg.InventoryStore`'s rollup of the same CRs;
  - --mode=placement: a battery of POST /v1/placements answers equals
    `tpufd_torch.placement.PlacementIndex.query`;
  - --mode=remedy (dry run): the journal's intents equal
    `tpufd_torch.remedy.RemedyEngine`'s actions on the same streams, a
    cordon for the crash-looping peer and none for the card's node.

Every daemon takes its introspection and placement addresses from
`tpufd_torch.fakes.free_loopback_port()`."""

import os

import pytest

import chip_smoke
from tpufd_torch import agg, sink
from tpufd_torch.fakes.apiserver import FakeApiServer

# A node CR shaped like the one the card's daemon publishes (H100 80GB
# HBM3, 700 W): the mock v5e-4's chip count, the perf labels the stand-in
# rating gives the card's readings, and health labels. The fixture adds
# the change-id and stage-SLO annotations a write carries.
CARD_LABELS = {
    "google.com/tpu.count": "4",
    "google.com/tpu.family": "v5e",
    "google.com/tpu.health.ok": "true",
    "google.com/tpu.health.dma-copy-gbps": "2877",
    "google.com/tpu.perf.class": "silver",
    "google.com/tpu.perf.hbm-gbps": "2996.928",
    "google.com/tpu.perf.matmul-tflops": "727.032",
    "google.com/tpu.perf.pct-of-rated": "74",
}


@pytest.fixture
def fleet(tmp_path):
    """A fake holding the card-shaped CR and the seeded peers, with the
    environment every fleet daemon gets; yields (server, env, said)."""
    said = []
    sa_dir = tmp_path / "serviceaccount"
    sa_dir.mkdir()
    stages = {"plan": agg.Sketch(), "publish": agg.Sketch()}
    for ms in (12.0, 15.0, 40.0):
        stages["plan"].add(ms)
        stages["publish"].add(ms / 4)
    with FakeApiServer() as server:
        server.seed(chip_smoke.FLEET_NS,
                    agg.CR_NAME_PREFIX + chip_smoke.CARD_NODE, CARD_LABELS,
                    {sink.NODE_NAME_LABEL: chip_smoke.CARD_NODE},
                    annotations={
                        sink.CHANGE_ANNOTATION: "7",
                        sink.SLO_ANNOTATION:
                            agg.serialize_stage_sketches(stages)})
        chip_smoke.seed_peers(server, said.append)
        base = {**os.environ, "GCE_METADATA_HOST": "127.0.0.1:1",
                chip_smoke.DAEMON_TAG: str(tmp_path)}
        yield server, chip_smoke.fleet_env(base, server, sa_dir), said
    print("\n".join(said))


def test_aggregator_inventory_equals_the_twin(tfd_binary, fleet, tmp_path):
    server, env, said = fleet
    labels = chip_smoke.fleet_aggregator(tfd_binary, server, env, tmp_path,
                                         said.append)
    assert labels[agg.FLEET_NODES] == "4"
    assert labels[agg.CAPACITY_PREFIX + "silver"] != "0"
    assert labels[agg.FLEET_MATMUL_P50]
    assert "google.com/tpu.obs.stage.plan.p50-ms" in labels


def test_placement_answers_equal_the_twin(tfd_binary, fleet, tmp_path):
    server, env, said = fleet
    chip_smoke.fleet_aggregator(tfd_binary, server, env, tmp_path,
                                said.append)
    rank = chip_smoke.fleet_placement(tfd_binary, server, env, tmp_path,
                                      chip_smoke.CARD_NODE, said.append)
    assert rank >= 1
    answers = [line for line in said if line.startswith("POST")]
    assert len(answers) == 4
    assert any("no-c" in line for line in answers)  # the oversized job


def test_remedy_intents_equal_the_twin(tfd_binary, fleet, tmp_path):
    server, env, said = fleet
    chip_smoke.fleet_aggregator(tfd_binary, server, env, tmp_path,
                                said.append)
    intents = chip_smoke.fleet_remedy(tfd_binary, server, env, tmp_path,
                                      chip_smoke.CARD_NODE, "peer-degraded",
                                      said.append)
    assert intents == sorted([("cordon", "peer-degraded", "crash-loop"),
                              ("rebuild-recommend", "", "capacity")])
