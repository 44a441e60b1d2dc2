"""Text-LM families of the agent configurations, looked up by name.

An agent configuration (one with `tts`) names its text LM's family in
`lm_family`, `qwen3` where the key is absent: the module `<name>.py` in
this directory. Each function of a family is read at one place:

- `lm_config(cfg) -> dict`: the LM's sizes, which its other functions take
  (`run.py`, once the family is loaded);
- `make_weights(cfg, seed, device) -> dict`: seeded weights on the device
  (`run.py`, beside the TTS's);
- `build(run, weights) -> lm`: the port's LM over those weights, the
  configuration's lower-precision control under `--control`; `lm` has
  `generate_stream(prompt, max_new, chunk, stop_ids)`,
  `warm(prompt_len, chunk_lengths)`, `steps` and `decode_launches()`
  (`entries/agent.py`);
- `check_numbers(weights, cfg, replies, plan, seed) -> dict`: the plain
  reference's numbers for a sample of the served replies, `lm_gap` and
  `tokens_checked` (`run.py`, beside the TTS's);
- `token_flops(cfg, pos)`, `prefill_flops(cfg, P)`: model FLOPs of one
  reply id at position `pos` and of a `P`-id prompt (`metrics/model_mfu.py`);
- `b1_step_cost(cfg, pos) -> (bytes, flops) | None`: what one decode step
  in the decode-step kernel B1 must move and do, None where the family's
  steps do not run in B1 (`metrics/decode_step_roofline.py`).
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "qwen3"


def load(cfg: dict):
    """The family module that the agent configuration `cfg` names; a
    `LookupError` naming the family and this directory where there is none."""
    name = cfg.get("lm_family", DEFAULT)
    if not (isinstance(name, str) and name.isidentifier() and (HERE / f"{name}.py").is_file()):
        raise LookupError(f"no text-LM family {name!r}: {HERE} has no {name}.py")
    return importlib.import_module(f"{__name__}.{name}")
