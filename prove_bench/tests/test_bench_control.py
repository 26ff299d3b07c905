"""The control and the faults: a run whose timed path is broken
underneath has to come out not correct, and a sound one correct.  The
harness's look for a card is skipped (device="cpu"); everything else of a
run is driven as on the card, on a fixture cell."""

import numpy as np
import pytest

from prove_bench import control, run
from prove_bench.tests.fixtures import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def one_run(root, cell, patch=None, seconds="0.1"):
    results = []
    rc = run.main(["--workload", cell, "--seed", "4000000007", "--seconds", seconds,
                   "--trace", "0"], device="cpu", root=root, patch=patch,
                  results=results)
    assert rc == 0
    return results[0]


def unchanged(statement):
    """A step that returns its state unchanged: every proof is the warm-up's."""
    prove = statement.prove
    first = []

    def stale(i, timing):
        if not first:
            first.append(prove(i, timing))
        return first[0]
    statement.prove = stale


def altered(statement):
    """An answer altered where it is produced: one opening of every proof."""
    prove = statement.prove

    def bent(i, timing):
        proof = prove(i, timing)
        o = proof.proof.openings
        field = "local_values" if hasattr(o, "local_values") else "wires"
        values = getattr(o, field).copy()
        values[1, 0] ^= np.uint64(1)
        setattr(o, field, values)
        return proof
    statement.prove = bent


def wrong_public(statement):
    """The statement proved for other public values than the inputs'."""
    prove = statement.prove

    def other(i, timing):
        return prove(i + 1, timing)
    statement.prove = other


@pytest.mark.parametrize("cell", ["stark_2p6", "plonk_m2"])
def test_sound_run_is_correct(root, cell):
    assert one_run(root, cell)["correct"]


@pytest.mark.parametrize("cell", ["stark_2p6", "plonk_m2"])
@pytest.mark.parametrize("fault", [unchanged, altered, wrong_public])
def test_faults_are_not_correct(root, cell, fault):
    result = one_run(root, cell, patch=fault)
    assert not result["correct"]
    assert result["checks"]["rejected"]["value"] + \
        result["checks"]["public_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", ["stark_2p6", "plonk_m2"])
def test_control_is_not_correct(root, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "11,12,13", "--seconds", "0.1"],
                        device="cpu", root=root) == 0
    import json
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["readings"]) == 3
    assert all(not r["correct"] and r["rejected"] > 0 for r in out["readings"])
