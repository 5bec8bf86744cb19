"""The program's side of a configuration: its own configuration object for
a configuration file, checked against the file's sizes.  The only module of
``harness`` that imports the program, inside its function."""
from __future__ import annotations

import dataclasses


def port_config(c: dict):
    """The program's configuration for the configuration file ``c``,
    checked against the file's sizes."""
    from repro_torch.configs import get_config
    cfg = get_config(c["port"]["config"])
    if c["port"].get("overrides"):
        cfg = dataclasses.replace(cfg, **c["port"]["overrides"])
    if cfg.family == "linear":
        want = {"d_model": c["features"]}
    else:
        want = {"d_model": c["hidden_size"], "n_layers": c["num_hidden_layers"],
                "n_heads": c["num_attention_heads"],
                "n_kv_heads": c["num_key_value_heads"],
                "head_dim_": c["head_dim"], "d_ff": c["intermediate_size"],
                "vocab": c["vocab_size"], "n_experts": c["num_experts"],
                "top_k": c["num_experts_per_tok"], "qk_norm": c["qk_norm"],
                "rope_theta": c["rope_theta"],
                "capacity_factor": c["capacity_factor"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"the program's {cfg.name} differs from the "
                         f"configuration file: {got} != {want}")
    return cfg


def load_kernels() -> dict:
    """Build the program's CUDA kernels where this checkout has no build of
    their sources yet, and load them; the seconds it took and whether it
    built, so that a run can report the build apart from the rest of its
    set-up."""
    from repro_torch.kernels import _build
    _build.load()
    return {"kernel_load_s": _build.last_build["seconds"],
            "kernel_built": _build.last_build["built"]}
