"""GeoBench's dataset helpers (mirrors part of `freefine_tpu.data.geobench`):
so far the difficulty levels that `metrics.main --level` filters by."""

from __future__ import annotations

from typing import Dict

DEGREES = {
    1: ("lightly", "slightly", "gently", "mildly"),
    2: ("moderately", "markedly", "appreciably"),
    3: ("heavily", "intensely", "significantly", "strongly"),
}


def difficulty_level(edit_prompt: str) -> int:
    """1-3 by the adverb in the edit prompt (the reference's
    classify_edit_prompt); a prompt with none raises."""
    p = edit_prompt.lower()
    for level, words in DEGREES.items():
        if any(w in p for w in words):
            return level
    raise ValueError(f"No Level found for {edit_prompt}")


def filter_by_level(data: Dict, level: int) -> Dict:
    """Drop, in place, the cases whose prompt's level is not `level`."""
    for da in data.values():
        for ins in da.get("instances", {}).values():
            for case_id in [c for c, gt in ins.items()
                            if difficulty_level(gt.get("edit_prompt", "")) != level]:
                ins.pop(case_id)
    return data
