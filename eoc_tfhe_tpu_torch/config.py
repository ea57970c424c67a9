"""One typed configuration for the framework.

Port of ``eoc_tfhe_tpu/config.py``: the same fields, choices and JSON form.  What each field drives in the port:

  * ``param_set``     -> :meth:`FrameworkConfig.params`
  * ``eval_key_form`` -> :meth:`FrameworkConfig.prepare_eval_key`:
    "ntt" and "ntt_rounded" -> the exact "ntt_kernel" form (the reference
    resolves "ntt_rounded" to the exact plan at every parameter set),
    "fused" -> "compact", "rows" -> "compact" with the exact key (the same
    rows and bits as the reference's "rows" form)
  * ``rotation_impl`` selects the TPU's rotation code in the reference and
    changes no bits; every choice gives the port's one rotation.
  * ``enable_jwt`` / ``jwt_rs256`` -> the JWT gate of ``api.tfhe.Tfhe``
  * ``profile_echo`` -> ``utils.profiling.PROFILER.echo``
    (:meth:`FrameworkConfig.apply_profiling`, run by ``TfheSession``)

The consumers of the remaining fields (``make_gate_server``, ``make_mesh``
and the benchmark's batch: serving and the parallel paths) are not ported
yet.  Those fields keep the reference's defaults, so the JSON form matches
the reference's, and a config that sets any of them to another value is
refused rather than silently ignored.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import types

from .core.params import (GateBootstrappingParams, default_128bit_params,
                          default_80bit_params, test_params)

#: Valid ``eval_key_form`` values (the reference's names).
EVAL_KEY_FORM_CHOICES = ("ntt", "ntt_rounded", "fused", "rows")

#: Valid ``rotation_impl`` values (the reference's names).
ROTATION_IMPL_CHOICES = ("auto", "gather", "onehot", "barrel")

#: Fields whose consumer is not ported yet -> what it waits for.
NOT_PORTED = {
    "mesh_dp": "make_mesh (parallel)",
    "mesh_tp": "make_mesh (parallel)",
    "batch_size": "the benchmark's default batch",
    "serving_max_batch": "make_gate_server (serving)",
    "serving_max_delay_s": "make_gate_server (serving)",
    "serving_pipeline_chunk": "make_gate_server (serving)",
}

_GATES = ("nand", "and_", "or_", "nor", "xor_", "xnor", "andny", "andyn", "orny", "oryn",
          "mux")


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Everything tunable, in one frozen value."""

    param_set: str = "128"            # "128", "80" or "test"
    rotation_impl: str = "auto"       # see ROTATION_IMPL_CHOICES
    eval_key_form: str = "ntt"        # see EVAL_KEY_FORM_CHOICES
    enable_jwt: bool = True
    jwt_rs256: bool = False
    mesh_dp: int = 0
    mesh_tp: int = 1
    batch_size: int = 8192
    profile_echo: bool = False
    serving_max_batch: int = 2048
    serving_max_delay_s: float = 0.005
    serving_pipeline_chunk: int = 128

    def __post_init__(self) -> None:
        if self.eval_key_form not in EVAL_KEY_FORM_CHOICES:
            raise ValueError(f"eval_key_form {self.eval_key_form!r} not in "
                             f"{EVAL_KEY_FORM_CHOICES}")
        if self.rotation_impl not in ROTATION_IMPL_CHOICES:
            raise ValueError(f"rotation_impl {self.rotation_impl!r} not in "
                             f"{ROTATION_IMPL_CHOICES}")
        for f in dataclasses.fields(self):
            if f.name in NOT_PORTED and getattr(self, f.name) != f.default:
                raise ValueError(f"{f.name}={getattr(self, f.name)!r}: its consumer, "
                                 f"{NOT_PORTED[f.name]}, is not ported yet; only the "
                                 f"default {f.default!r} is accepted")

    def params(self) -> GateBootstrappingParams:
        return {"128": default_128bit_params, "80": default_80bit_params,
                "test": test_params}[self.param_set]()

    def prepare_eval_key(self, cloud, params: GateBootstrappingParams | None = None):
        """The evaluation key in the configured form, on the cloud key's device.
        "fused" and "rows" (both the compact form) raise for halfBg > 128
        (the 80-bit set)."""
        from .core import bootstrap
        params = params or self.params()
        if self.eval_key_form in ("ntt", "ntt_rounded"):
            return bootstrap.prepare_eval_key_ntt(cloud, params)
        if self.eval_key_form == "fused":
            return bootstrap.prepare_eval_key_fused(cloud, params)
        return bootstrap.prepare_eval_key(cloud, params)

    def make_gate_api(self, keyset, params: GateBootstrappingParams | None = None):
        """Bound boolean-gate namespace: every gate carries this config's eval
        key (the reference's ``boots*`` surface with explicit keys)."""
        from .core import gates
        params = params or self.params()
        ek = self.prepare_eval_key(keyset.cloud, params)
        ns = types.SimpleNamespace(eval_key=ek, params=params)
        for name in _GATES:
            setattr(ns, name, functools.partial(getattr(gates, name), ek=ek, params=params))
        ns.not_ = gates.not_
        ns.copy = gates.copy
        ns.constant = functools.partial(gates.constant, params=params,
                                        device=ek.bk_rows.device)
        return ns

    def apply_profiling(self) -> None:
        """Apply the profiling echo flag to the process profiler."""
        from .utils.profiling import PROFILER
        PROFILER.echo = self.profile_echo

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "FrameworkConfig":
        return cls(**json.loads(s))


DEFAULT_CONFIG = FrameworkConfig()
