"""eoc_tfhe_tpu_torch — the TFHE gate-bootstrapping library in PyTorch and CUDA.

The port of ``eoc_tfhe_tpu`` (JAX) to an NVIDIA H100.  It keeps the
reference's module layout and names:

  core.params / core.numeric       parameter sets, exact Torus32 arithmetic
  core.lwe / tlwe / tgsw           batched ciphertext algebra
  ops.polymul / rotate / keyswitch exact polynomial products, rotations, key switching
  ops.ntt                          CRT-NTT contexts and the NTT-domain bootstrapping keys
  ops.blind_rotate                 blind rotation over the int16 NTT key: CUDA kernel + plain version
  ops.blind_rotate_v1              blind rotation over the byte-pair NTT key: CUDA kernel + plain version
  ops.blind_rotate_compact         blind rotation over the stored key: CUDA kernel + plain version
  core.keys / bootstrap / gates    keygen, gate bootstrapping, boolean gates, MUX/MAJ/refresh
  circuits.adder                   integer circuits: add, sub, mul, compare, equals, select
  io.tfhe_io                       the reference-compatible wire codec
  io.native_keys                   the sharded key directory format, each rank its own shards
  io.virtualfs / models            the virtual FS and the llama tier
  parallel.mesh / distributed      (dp, tp) meshes of torch.distributed ranks, their collectives
  parallel.sharded                 the dp gate and the tp blind rotations across ranks
  api.tfhe / api.jwt               the ``Tfhe.*`` string API and its JWT gate
  serving                          the batching gate server (GateServer)
  lua / process                    the Lua interpreter and the AO process runtime (Process, Router)
  utils.profiling                  per-op timers and spans on the profiler's clock
  config                           FrameworkConfig: parameter set, eval-key form, JWT, echo,
                                   serving, mesh
  kernels.build                    builds ``csrc/*.cu`` with nvcc at first use

Entry points that create tensors take ``device=`` and default to the card;
without a card they raise instead of running on the CPU.  ``Tfhe`` and
``TfheSession`` are importable from the package root.
"""


def __getattr__(name: str):
    if name in ("Tfhe", "TfheSession"):
        from .api import tfhe
        return getattr(tfhe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
