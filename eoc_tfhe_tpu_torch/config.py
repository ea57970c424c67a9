"""One typed configuration for the framework.

Port of ``eoc_tfhe_tpu/config.py``: the same fields, choices and JSON form.  What each field drives in the port:

  * ``param_set``     -> :meth:`FrameworkConfig.params`
  * ``eval_key_form`` -> :meth:`FrameworkConfig.prepare_eval_key`:
    "ntt" -> the "ntt_kernel" form, "ntt_rounded" -> the "ntt_kernel" form
    with the reference's rounded-key plan (``prepare_eval_key_ntt(
    rounded=True)``: exact at the shipped sets, rounded where
    ``ntt.choose_rounded_plan`` accepts a rounding, e.g. ``test_params(n=4)``),
    "fused" -> "compact", "rows" -> "compact" with the exact key (the same
    rows and bits as the reference's "rows" form)
  * ``rotation_impl`` -> bound into every gate and circuit call (by
    :meth:`make_gate_api`, :meth:`make_gate_server` and ``api.tfhe``); it
    selects the TPU's rotation code in the reference and changes no bits:
    every choice gives the port's one rotation.
  * ``enable_jwt`` / ``jwt_rs256`` -> the JWT gate of ``api.tfhe.Tfhe``
  * ``batch_size``    -> the batch of ``chip_smoke.py``'s NAND phases
  * ``profile_echo`` -> ``utils.profiling.PROFILER.echo``
    (:meth:`FrameworkConfig.apply_profiling`, run by ``TfheSession``)
  * ``serving_max_batch`` / ``serving_max_delay_s`` /
    ``serving_pipeline_chunk`` -> :meth:`make_gate_server`
    (``serving.GateServer``'s flush policy and chunked pipeline)
  * ``mesh_dp`` / ``mesh_tp`` -> :meth:`make_mesh` (a (dp, tp) layout of
    the process group's ranks, ``parallel.mesh``; 0 = every remaining rank
    on dp)
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

    def params(self) -> GateBootstrappingParams:
        return {"128": default_128bit_params, "80": default_80bit_params,
                "test": test_params}[self.param_set]()

    def prepare_eval_key(self, cloud, params: GateBootstrappingParams | None = None):
        """The evaluation key in the configured form, on the cloud key's device.
        "fused" and "rows" (both the compact form) raise for halfBg > 128
        (the 80-bit set)."""
        from .core import bootstrap
        params = params or self.params()
        if self.eval_key_form == "ntt":
            return bootstrap.prepare_eval_key_ntt(cloud, params)
        if self.eval_key_form == "ntt_rounded":
            return bootstrap.prepare_eval_key_ntt(cloud, params, rounded=True)
        if self.eval_key_form == "fused":
            return bootstrap.prepare_eval_key_fused(cloud, params)
        return bootstrap.prepare_eval_key(cloud, params)

    def make_gate_api(self, keyset, params: GateBootstrappingParams | None = None):
        """Bound boolean-gate namespace: every gate carries this config's eval
        key and rotation_impl (the reference's ``boots*`` surface with explicit
        keys)."""
        from .core import gates
        params = params or self.params()
        ek = self.prepare_eval_key(keyset.cloud, params)
        ns = types.SimpleNamespace(eval_key=ek, params=params)
        for name in _GATES:
            setattr(ns, name, functools.partial(getattr(gates, name), ek=ek, params=params,
                                                rotation_impl=self.rotation_impl))
        ns.not_ = gates.not_
        ns.copy = gates.copy
        ns.constant = functools.partial(gates.constant, params=params,
                                        device=ek.bk_rows.device)
        return ns

    def make_gate_server(self, ek, params: GateBootstrappingParams | None = None,
                         **overrides):
        """Batching gate server with this config's flush and pipeline policy
        (``serving.GateServer``); keyword overrides win, ``device`` among
        them (the card unless named)."""
        from .serving import GateServer
        params = params or self.params()
        kw = dict(max_batch=self.serving_max_batch, max_delay_s=self.serving_max_delay_s,
                  rotation_impl=self.rotation_impl,
                  pipeline_chunk=self.serving_pipeline_chunk)
        kw.update(overrides)
        return GateServer(ek, params, **kw)

    def make_mesh(self, device=None):
        """(dp, tp) mesh of the process group's ranks from the configured axis
        sizes; ``device`` is this rank's (the card unless named)."""
        from .parallel.mesh import make_mesh
        return make_mesh(dp=self.mesh_dp or None, tp=self.mesh_tp, device=device)

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
