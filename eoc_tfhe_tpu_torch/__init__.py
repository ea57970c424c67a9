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
  api.tfhe / api.jwt               the ``Tfhe.*`` string API and its JWT gate
  utils.profiling                  per-op timers
  config                           FrameworkConfig: parameter set, eval-key form, JWT, echo
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
