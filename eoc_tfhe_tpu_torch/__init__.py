"""eoc_tfhe_tpu_torch — the TFHE gate-bootstrapping library in PyTorch and CUDA.

The port of ``eoc_tfhe_tpu`` (JAX) to an NVIDIA H100.  It keeps the
reference's module layout and names:

  core.params / core.numeric       parameter sets, exact Torus32 arithmetic
  core.lwe / tlwe / tgsw           batched ciphertext algebra
  ops.polymul / rotate / keyswitch exact polynomial products, rotations, key switching
  ops.ntt                          CRT-NTT context and the NTT-domain bootstrapping key
  ops.blind_rotate                 blind rotation over the NTT key: CUDA kernel + plain version
  ops.blind_rotate_compact         blind rotation over the stored key: CUDA kernel + plain version
  core.keys / bootstrap / gates    keygen, gate bootstrapping, boolean gates, MUX/MAJ/refresh
  circuits.adder                   integer circuits: add, sub, mul, compare, equals, select
  config                           FrameworkConfig: parameter set and eval-key form
  kernels.build                    builds ``csrc/*.cu`` with nvcc at first use

Entry points that create tensors take ``device=`` and default to the card;
without a card they raise instead of running on the CPU.
"""
