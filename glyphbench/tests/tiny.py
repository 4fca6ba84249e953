"""Tiny definitions of the benchmark's cells for CPU tests: the real
traffic drivers and readers, configurations cut to a few dozen glyphs.
The tests put the program on the CPU (`conftest.program_on_the_cpu`)."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make(root: str) -> dict:
    """Write the tiny definitions under ``root``; returns {cell: its
    traffic kind}."""
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for d in ("traffic", "layers"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, d), dirs_exist_ok=True)
    with open(os.path.join(BENCH, "configs", "fira_sans_family.json")) as f:
        text = json.load(f)
    text["fonts"][0].update(styles=[["Regular", "fira_sans_regular"], ["Bold", "fira_sans_bold"],
                                    ["Italic", "fira_sans_regular_italic"]],
                            glyphs=40, codepoint_ranges=[[60, 80], [256, 261], [8192, 8194]])
    with open(os.path.join(BENCH, "configs", "noto_sans_cjk_sc.json")) as f:
        cjk = json.load(f)
    cjk["fonts"][0].update(glyphs=24, codepoint_ranges=[[13312, 13335]])
    for name, cfg in (("tiny_text", text), ("tiny_cjk", cjk)):
        with open(os.path.join(root, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    kinds = {}
    for name, cfg in (("fira_recurse_tar", "tiny_text"), ("cjk_merge_dir", "tiny_cjk"),
                      ("fira_fit_flat", "tiny_text")):
        with open(os.path.join(BENCH, "workloads", f"{name}.json")) as f:
            w = json.load(f)
        w["config"] = cfg
        if w["traffic"] == "fit_steps":
            w["params"].update(steps_per_call=2)
            # Limits of this size on the CPU's plain kernels: Adam's sign-sized
            # first steps over a dozen glyphs move the change's norm more.
            w["limits"].update(loss0_gap=1e-5, delta_norm_gap=5e-3)
        with open(os.path.join(root, "workloads", f"tiny_{name}.json"), "w") as f:
            json.dump(w, f)
        kinds[f"tiny_{name}"] = w["traffic"]
    return kinds
