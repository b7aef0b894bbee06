"""Curriculum learning: guidance sequencing and the curriculum plan.

Counterpart of ``flyp_tpu/training/curriculum.py``: training CSVs carry a
``guidance`` column (diffusion-strength curricula); the trainer walks the
guidance values in order, optionally looping each ``loop_times`` within a
fixed ``curriculum_epoch`` budget, or picks the next guidance by
per-guidance eval progress with a 15% exploration rate.  The CSV is read by
``data/csv_dataset.py::read_table`` (pandas' typing, without pandas).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from flyp_tpu_torch.data.csv_dataset import read_table


def seq_curri_guid(
    list_guidance: Sequence[int],
    cur_guidance_id: Optional[int] = None,
    cur_str_times: Optional[int] = None,
    ctype: str = "out_curri",
    loop_times: int = 1,
):
    """Advance the guidance cursor: ``no_curri`` cycles through the list,
    ``in_curri`` repeats each value ``loop_times`` then moves on (stopping
    at the last), ``out_curri`` jumps to guidance 100."""
    if ctype == "no_curri":
        cur_guidance_id += 1
        if cur_guidance_id >= len(list_guidance):
            cur_guidance_id = 0
        return cur_guidance_id, list_guidance[cur_guidance_id]

    if ctype == "in_curri":
        if cur_str_times < loop_times:
            cur_str_times += 1
        else:
            cur_str_times = 1
            cur_guidance_id += 1
            if cur_guidance_id >= len(list_guidance):
                cur_guidance_id = len(list_guidance) - 1
        return cur_guidance_id, list_guidance[cur_guidance_id], cur_str_times

    if ctype == "out_curri":
        cur_guidance = 100
        return list(list_guidance).index(cur_guidance), cur_guidance, 1

    raise ValueError(f"invalid ctype {ctype}")


@dataclasses.dataclass
class GuidanceSetting:
    cur_guidance_id: int = 0
    cur_guidance: Optional[int] = None
    list_guidance: Optional[List[int]] = None
    loop_times: int = 1
    len_data: Optional[int] = None
    num_batch_ori: Optional[int] = None


def init_guidance_setting(cfg, logger=None, list_classes=None) -> GuidanceSetting:
    """The curriculum plan from the training CSV: the guidance values, the
    row count, and under ``curriculum_epoch`` the guidance-100 batch count
    and how often each other guidance loops."""
    s = GuidanceSetting()

    if cfg.curriculum:
        table = read_table(cfg.ft_data, cfg.csv_separator)
        guidance = table["guidance"]
        if cfg.cont_finetune and list_classes is not None:
            keep = set(list_classes)
            guidance = [g for g, label in zip(guidance, table["label"]) if label in keep]
        s.len_data = len(guidance)
        s.list_guidance = sorted(set(guidance))
        s.cur_guidance_id = 0
        s.cur_guidance = s.list_guidance[0]
        if cfg.curriculum_epoch is not None:
            len_ori = sum(1 for g in guidance if g == 100)
            s.num_batch_ori = int(len_ori / cfg.batch_size)
            len_all_guid = len(guidance) - len_ori
            total_viewing = s.num_batch_ori * cfg.curriculum_epoch * cfg.batch_size
            s.loop_times = math.ceil(total_viewing / max(len_all_guid, 1))

    elif cfg.baseline:
        s.cur_guidance = 100
        s.list_guidance = [100]
        s.cur_guidance_id = 0

    if cfg.guidance != -1:
        table = read_table(cfg.ft_data, cfg.csv_separator)
        s.len_data = sum(1 for g in table["guidance"] if g == cfg.guidance)
        if cfg.datalimit != -1:
            if logger is not None:
                logger.info(f"Sample {cfg.datalimit} from original dataset")
            # The JAX package samples min(len, datalimit) rows; only the count is kept.
            s.len_data = min(s.len_data, cfg.datalimit)
        s.list_guidance = [cfg.guidance]
        s.cur_guidance_id = 0
        s.cur_guidance = cfg.guidance

    return s


def choose_guidance_by_progress(
    res_progress: dict,
    list_guidance: Sequence[int],
    explore: bool,
    rng: np.random.Generator,
) -> Tuple[int, int]:
    """The guidance with the largest eval progress, or with ``explore`` and
    probability 0.15 a uniformly drawn one."""
    ranked = sorted(res_progress.items(), key=lambda kv: kv[1], reverse=True)
    if explore and rng.uniform() <= 0.15:
        pick = ranked[int(rng.integers(0, len(ranked)))]
    else:
        pick = ranked[0]
    cur_guidance = pick[0]
    return list(list_guidance).index(cur_guidance), cur_guidance
