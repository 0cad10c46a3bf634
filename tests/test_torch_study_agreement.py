"""``tools.study_agreement`` on prepared runs: each class a candidate can be
filed under, read from a log and a ``scenario_results/`` folder as the
pipeline writes them."""

import json

from tools import study_agreement as sa

LOG_A = """scene 0: feasible (2 candidate attackers)
scene 1: infeasible, skip
scene 2: feasible (1 candidate attackers)
scene 3: feasible (3 candidate attackers)
Optimizing batch of 3 scenes [0, 2, 3]
Planner pre-collision: dropping 1/3 scenes
adv successes: [True, False]
scene 4: feasible (1 candidate attackers)
scene 5: feasible (1 candidate attackers)
Optimizing batch of 2 scenes [4, 5]
"""
LOG_B = """scene 0: feasible (2 candidate attackers)
scene 1: infeasible, skip
scene 2: feasible (1 candidate attackers)
scene 3: feasible (3 candidate attackers)
Optimizing batch of 3 scenes [0, 2, 3]
Planner pre-collision: dropping 1/3 scenes
adv successes: [False, False]
scene 4: feasible (1 candidate attackers)
scene 5: feasible (1 candidate attackers)
scene 6: infeasible, skip
scene 7: feasible (2 candidate attackers)
Optimizing batch of 3 scenes [4, 5, 7]
adv successes: [False, True, False]
"""


def run_dir(root, log, filed):
    for folder, scenes in filed.items():
        d = root / "scenario_results" / folder
        d.mkdir(parents=True)
        for i in scenes:
            (d / f"scene_{i:04d}.json").write_text("{}")
    (root / "adv_gen_log.txt").write_text(log)
    return str(root)


def test_classes_and_agreement(tmp_path, capsys):
    """A: scene 3 dropped before the optimization, the batch of 4 and 5
    cut before its successes, 6 and 7 past the log's end. B: every batch
    finished."""
    a = run_dir(tmp_path / "a", LOG_A, {"adv_sol_success": [0],
                                        "adv_failed": [2]})
    b = run_dir(tmp_path / "b", LOG_B, {"sol_failed": [0, 5],
                                        "adv_failed": [2, 4, 7]})
    assert sa.classes(a, 8) == {
        0: "adv_sol_success", 1: "infeasible", 2: "adv_failed",
        3: "pre_collision", 4: "unfinished", 5: "unfinished",
        6: "unscreened", 7: "unscreened"}
    assert sa.classes(b, 8) == {
        0: "sol_failed", 1: "infeasible", 2: "adv_failed",
        3: "pre_collision", 4: "adv_failed", 5: "sol_failed",
        6: "infeasible", 7: "adv_failed"}
    got = sa.agreement(a, b, 8)
    assert got["alike"] == 3 and got["scenes"] == 8
    assert got["differ"] == {0: ["adv_sol_success", "sol_failed"],
                             4: ["unfinished", "adv_failed"],
                             5: ["unfinished", "sol_failed"],
                             6: ["unscreened", "infeasible"],
                             7: ["unscreened", "adv_failed"]}
    assert got["port_adv_success"] == [0]
    assert got["jax_adv_success"] == [0, 5]
    assert got["port"] == {"adv_sol_success": 1, "infeasible": 1,
                           "adv_failed": 1, "pre_collision": 1,
                           "unfinished": 2, "unscreened": 2}
    assert got["jax_classes"] == [sa.classes(b, 8)[i] for i in range(8)]
    assert sa.main(["--scenes", "8", "--pair", "ab", a, b]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == {"ab": json.loads(json.dumps(got))}


def test_a_run_against_itself(tmp_path):
    a = run_dir(tmp_path / "a", LOG_B, {"adv_failed": [0, 2, 4, 5, 7]})
    got = sa.agreement(a, a, 10)
    assert got["alike"] == 10 and got["differ"] == {}
    assert got["port_classes"][8:] == ["unscreened", "unscreened"]
