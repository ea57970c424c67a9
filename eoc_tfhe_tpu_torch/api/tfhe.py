"""High-level ``Tfhe`` API: the reference Lua module's string surface.

Port of ``eoc_tfhe_tpu/api/tfhe.py``: base64-string ciphertexts, the
``Msize = 2^31 - 1`` integer encoding, ``alpha = 1/(10*Msize)`` leveled
noise, the JWT gate, and bootstrapped uint8 arithmetic over the circuit
layer.  Two tiers, with the reference's method names and argument order:

  * :class:`TfheSession` — explicit-key API;
  * :class:`Tfhe` — the ``Tfhe.*`` facade with the reference's quirks
    (``encryptInteger_dummy`` aliases ``encryptInteger``; the JWT gate sits on
    ``generateSecretKey``, ``decryptInteger``, ``decryptASCIIString`` and
    ``decryptUint8``; ``subtractCiphertexts`` really subtracts, where the
    reference's Lua layer aliases it to addition and gives 58 for 50 - 8).

Both take ``device=`` and run on the card unless the caller names the CPU.
One ``torch.Generator`` on that device, seeded from ``seed``, draws every
key and every encryption's randomness.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np
import torch

from ..circuits import adder
from ..core import gates, lwe
from ..core.keys import SecretKeySet, new_random_gate_bootstrapping_secret_keyset
from ..core.numeric import mod_switch_from_torus32_np, mod_switch_to_torus32_np
from ..core.params import GateBootstrappingParams
from ..device import resolve_device
from ..io import tfhe_io
from ..io.tfhe_io import to_numpy
from ..utils.profiling import op_timer
from .jwt import validate_jwt

#: The reference wrapper's constants (eoc-tfhe-run.cpp:34-36).
MINIMUM_LAMBDA = 128
MSIZE = (1 << 31) - 1
ALPHA = 1.0 / (10.0 * MSIZE)


class TfheSession:
    """Explicit-key API over the reference wrapper's operation set."""

    def __init__(self, params: GateBootstrappingParams | None = None,
                 seed: int | None = None, config=None, device=None):
        from ..config import DEFAULT_CONFIG
        self.config = config or DEFAULT_CONFIG
        self.config.apply_profiling()
        self.params = params if params is not None else self.config.params()
        self.device = resolve_device(device)
        if seed is None:
            # fresh OS entropy: a fixed default would give every session the
            # same secret key; deterministic callers pass a seed
            seed = int.from_bytes(os.urandom(8), "little") >> 1
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.keyset: SecretKeySet | None = None
        self._gate_api = None

    def gate_api(self):
        """Bound boolean-gate namespace over the config's eval-key form; built
        on first use."""
        if self._gate_api is None:
            self._gate_api = self.config.make_gate_api(self._require_key(), self.params)
        return self._gate_api

    # -- key management ----------------------------------------------------

    def generate_secret_key(self) -> str:
        """Generate (once) and export the secret keyset as base64."""
        with op_timer("generateSecretKey"):
            if self.keyset is None:
                self.keyset = new_random_gate_bootstrapping_secret_keyset(
                    self._gen, self.params, device=self.device)
            return tfhe_io.b64encode(tfhe_io.export_secret_keyset(self.keyset, self.params))

    def generate_public_key(self) -> str:
        """Export the cloud (evaluation) keyset as base64."""
        ks = self._require_key()
        with op_timer("generatePublicKey"):
            return tfhe_io.b64encode(tfhe_io.export_cloud_keyset(ks.cloud, self.params))

    def import_secret_key(self, b64: str) -> None:
        self.keyset, self.params = tfhe_io.import_secret_keyset(tfhe_io.b64decode(b64),
                                                                device=self.device)
        # the cached gate API holds an eval key of the previous cloud key
        self._gate_api = None

    def _require_key(self) -> SecretKeySet:
        if self.keyset is None:
            raise RuntimeError("Secret key not initialized. Generate the secret key first.")
        return self.keyset

    # -- integers (leveled) ------------------------------------------------

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def encrypt_integer(self, value: int) -> str:
        ks = self._require_key()
        with op_timer("encryptInteger"):
            mu = self._tensor(mod_switch_to_torus32_np(int(value), MSIZE), torch.int32)
            return self._export_lwe(lwe.lwe_sym_encrypt(self._gen, mu, ALPHA, ks.lwe_key))

    def decrypt_integer(self, b64_ct: str) -> int:
        ks = self._require_key()
        with op_timer("decryptInteger"):
            phase = int(lwe.lwe_phase(self._import_lwe(b64_ct), ks.lwe_key))
            return int(mod_switch_from_torus32_np(np.int32(phase), MSIZE))

    def _import_lwe(self, b64_ct: str) -> lwe.LweCiphertext:
        f = _io.BytesIO(tfhe_io.b64decode(b64_ct))
        a, b, var = tfhe_io.read_lwe_sample(f, self.params.n)
        return lwe.LweCiphertext(a=self._tensor(a, torch.int32), b=self._tensor(b, torch.int32),
                                 current_variance=self._tensor(np.float32(var), torch.float32))

    def _export_lwe(self, ct: lwe.LweCiphertext) -> str:
        f = _io.BytesIO()
        tfhe_io.write_lwe_sample(f, to_numpy(ct.a), int(ct.b), float(ct.current_variance))
        return tfhe_io.b64encode(f.getvalue())

    # -- ASCII strings -----------------------------------------------------

    def encrypt_ascii_string(self, text: str) -> str:
        ks = self._require_key()
        with op_timer("encryptASCIIString"):
            vals = np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int64)
            mus = self._tensor(mod_switch_to_torus32_np(vals, MSIZE), torch.int32)
            return self._export_samples(lwe.lwe_sym_encrypt(self._gen, mus, ALPHA, ks.lwe_key))

    def decrypt_ascii_string(self, b64_ct: str, msg_length: int) -> str:
        ks = self._require_key()
        with op_timer("decryptASCIIString"):
            a, b, _ = tfhe_io.unpack_lwe_samples(tfhe_io.b64decode(b64_ct), msg_length,
                                                 self.params.n)
            ct = lwe.LweCiphertext(
                a=self._tensor(a, torch.int32), b=self._tensor(b, torch.int32),
                current_variance=torch.zeros(msg_length, dtype=torch.float32,
                                             device=self.device))
            vals = mod_switch_from_torus32_np(to_numpy(lwe.lwe_phase(ct, ks.lwe_key)), MSIZE)
            return "".join(chr(int(v) & 0xFF) for v in vals)

    # -- leveled arithmetic ------------------------------------------------

    def add_ciphertexts(self, b64_c1: str, b64_c2: str) -> str:
        self._require_key()
        with op_timer("addCiphertexts"):
            return self._export_lwe(lwe.lwe_add(self._import_lwe(b64_c1),
                                                self._import_lwe(b64_c2)))

    def subtract_ciphertexts(self, b64_c1: str, b64_c2: str) -> str:
        self._require_key()
        with op_timer("subtractCiphertexts"):
            return self._export_lwe(lwe.lwe_sub(self._import_lwe(b64_c1),
                                                self._import_lwe(b64_c2)))

    # -- bootstrapped uint8 arithmetic (beyond the reference) --------------
    # A uint8 is 8 gate-encoded LWE samples (mu = +-1/8), LSB first; the
    # operations run the circuit layer, and every gate resets the noise.

    def _bits(self, value: int) -> torch.Tensor:
        return torch.tensor([(int(value) >> i) & 1 for i in range(8)], dtype=torch.bool,
                            device=self.device)

    def encrypt_uint8_bits(self, value: int) -> str:
        """uint8 -> 8 gate-encoded LWE samples (LSB first), packed base64."""
        ks = self._require_key()
        with op_timer("encryptUint8Bits"):
            return self._export_samples(gates.encrypt_bit(self._gen, self._bits(value),
                                                          ks.lwe_key, self.params))

    def decrypt_uint8_bits(self, b64_ct: str) -> int:
        ks = self._require_key()
        with op_timer("decryptUint8Bits"):
            bits = to_numpy(gates.decrypt_bit(self._import_bits(b64_ct), ks.lwe_key))
            return int(sum(int(b) << i for i, b in enumerate(bits)))

    def encrypt_uint8_bits_seeded(self, value: int) -> str:
        """uint8 -> 8 seeded gate-encoded samples (UID-242 records, 32 B each
        against 2,532 B for a full sample); every uint8 consumer takes both."""
        ks = self._require_key()
        with op_timer("encryptUint8BitsSeeded"):
            ct = gates.encrypt_bit_seeded(self._gen, self._bits(value), ks.lwe_key,
                                          self.params)
            return tfhe_io.b64encode(tfhe_io.pack_seeded_lwe_samples(
                to_numpy(ct.seed), to_numpy(ct.b),
                to_numpy(ct.current_variance).astype(np.float64)))

    def _import_bits(self, b64_ct: str) -> lwe.LweCiphertext:
        data = tfhe_io.b64decode(b64_ct)
        uid = int.from_bytes(data[:4], "little") if len(data) >= 4 else -1
        if uid == tfhe_io.SEEDED_LWE_SAMPLE_UID:
            seed, b, v = tfhe_io.unpack_seeded_lwe_samples(data, 8)
            return lwe.lwe_seeded_expand(lwe.SeededLweCiphertext(
                seed=self._tensor(seed.astype(np.int64), torch.int64),
                b=self._tensor(b, torch.int32),
                current_variance=self._tensor(v.astype(np.float32), torch.float32)),
                self.params.n)
        a, b, v = tfhe_io.unpack_lwe_samples(data, 8, self.params.n)
        return lwe.LweCiphertext(a=self._tensor(a, torch.int32), b=self._tensor(b, torch.int32),
                                 current_variance=self._tensor(v.astype(np.float32),
                                                               torch.float32))

    def _export_samples(self, ct: lwe.LweCiphertext) -> str:
        """The one LWE-batch export: pack_lwe_samples + base64."""
        return tfhe_io.b64encode(tfhe_io.pack_lwe_samples(
            to_numpy(ct.a), to_numpy(ct.b), to_numpy(ct.current_variance).astype(np.float64)))

    def _circuit_binop(self, fn, b64_a: str, b64_b: str) -> str:
        self._require_key()
        api = self.gate_api()
        out, _flag = fn(self._import_bits(b64_a), self._import_bits(b64_b), api.eval_key,
                        api.params)
        return self._export_samples(out)

    def add_uint8_bits(self, b64_a: str, b64_b: str) -> str:
        """Bootstrapped 8-bit addition mod 256 (the fast ripple adder)."""
        with op_timer("addUint8Bits"):
            return self._circuit_binop(adder.ripple_carry_add, b64_a, b64_b)

    def subtract_uint8_bits(self, b64_a: str, b64_b: str) -> str:
        """Bootstrapped 8-bit subtraction mod 256."""
        with op_timer("subtractUint8Bits"):
            return self._circuit_binop(adder.ripple_borrow_sub, b64_a, b64_b)

    def multiply_uint8_bits(self, b64_a: str, b64_b: str) -> str:
        """Bootstrapped 8-bit multiplication mod 256 (array multiplier)."""
        with op_timer("multiplyUint8Bits"):
            return self._circuit_binop(adder.ripple_mul, b64_a, b64_b)

    def _pack_bit_as_u8(self, bit_ct: lwe.LweCiphertext) -> str:
        """One bit as a uint8 blob (value 0/1): the bit in slot 0, trivial
        false above it."""
        pad = gates.constant(torch.zeros(tuple(bit_ct.b.shape), dtype=torch.bool),
                             self.params, device=self.device)
        return self._export_samples(lwe.lwe_stack([bit_ct] + [pad] * 7))

    def less_than_uint8_bits(self, b64_a: str, b64_b: str) -> str:
        """Bootstrapped unsigned a < b as an encrypted uint8 0/1."""
        self._require_key()
        api = self.gate_api()
        with op_timer("lessThanUint8Bits"):
            lt = adder.compare_lt(self._import_bits(b64_a), self._import_bits(b64_b),
                                  api.eval_key, api.params)
            return self._pack_bit_as_u8(lt)

    def equals_uint8_bits(self, b64_a: str, b64_b: str) -> str:
        """Bootstrapped a == b as an encrypted uint8 0/1."""
        self._require_key()
        api = self.gate_api()
        with op_timer("equalsUint8Bits"):
            eq = adder.equals(self._import_bits(b64_a), self._import_bits(b64_b),
                              api.eval_key, api.params)
            return self._pack_bit_as_u8(eq)

    def select_uint8_bits(self, b64_c: str, b64_a: str, b64_b: str) -> str:
        """Bootstrapped select: bit 0 of c picks a (1) or b (0), per bit."""
        self._require_key()
        api = self.gate_api()
        with op_timer("selectUint8Bits"):
            cc = self._import_bits(b64_c)
            out = adder.select_word(lwe.lwe_index(cc, 0), self._import_bits(b64_a),
                                    self._import_bits(b64_b), api.eval_key, api.params)
            return self._export_samples(out)


class Tfhe:
    """The ``Tfhe.*`` Lua surface (tfhe.lua:4-53) over a process-global key.

    Method names and argument order follow the Lua module; the JWT token and
    JWKS arguments gate the operations where the reference gates them.
    """

    def __init__(self, params: GateBootstrappingParams | None = None, seed: int = 0,
                 config=None, device=None):
        self._s = TfheSession(params, seed, config=config, device=device)
        self.config = self._s.config

    def _jwt_ok(self, token: str, jwks: str = "") -> bool:
        # enable_jwt=False turns the gate off; jwt_rs256=True verifies the
        # signature against the JWKS instead of the structural check
        if not self.config.enable_jwt:
            return True
        if self.config.jwt_rs256:
            from .jwt import verify_rs256
            return verify_rs256(token, jwks)
        return validate_jwt(token)

    def info(self) -> str:
        return ("TFHE Library: Enabling fully homomorphic encryption computations "
                "on encrypted data.\nJWT support: Enabled\nOpenSSL support: Enabled")

    def testJWT(self) -> bool:
        # the reference encrypts and decrypts a demo string, then checks a
        # static token structurally
        if self._s.keyset is not None:
            ct = self._s.encrypt_ascii_string("Hello Weavers!")
            assert self._s.decrypt_ascii_string(ct, 14) == "Hello Weavers!"
        return validate_jwt("header.payload")

    def generateSecretKey(self, token: str = "a.b", jwks: str = "") -> str | None:
        # an invalid JWT gives nullptr in the reference
        if not self._jwt_ok(token, jwks):
            return None
        return self._s.generate_secret_key()

    def generatePublicKey(self, token: str = "", jwks: str = "") -> str:
        return self._s.generate_public_key()

    def encryptInteger(self, value: int, key: str = "") -> str:
        return self._s.encrypt_integer(value)

    # the reference binds encryptInteger_dummy to the same function
    encryptInteger_dummy = encryptInteger

    def decryptInteger(self, ct: str, key: str = "", token: str = "a.b",
                       jwks: str = "") -> int:
        # validated unconditionally, as the reference does: an empty token fails
        if not self._jwt_ok(token, jwks):
            return -1
        return self._s.decrypt_integer(ct)

    def encryptASCIIString(self, text: str, length: int | None = None, key: str = "") -> str:
        return self._s.encrypt_ascii_string(text if length is None else text[:length])

    def decryptASCIIString(self, ct: str, length: int, key: str = "", token: str = "a.b",
                           jwks: str = "") -> str | None:
        if not self._jwt_ok(token, jwks):
            return None
        return self._s.decrypt_ascii_string(ct, length)

    def addCiphertexts(self, c1: str, c2: str, key: str = "") -> str:
        return self._s.add_ciphertexts(c1, c2)

    def subtractCiphertexts(self, c1: str, c2: str, key: str = "") -> str:
        # real subtraction (the reference's Lua layer aliases it to add)
        return self._s.subtract_ciphertexts(c1, c2)

    # -- bootstrapped 8-bit arithmetic -------------------------------------

    def encryptUint8(self, value: int, key: str = "") -> str:
        return self._s.encrypt_uint8_bits(int(value))

    def encryptUint8Seeded(self, value: int, key: str = "") -> str:
        """Seeded-mask uint8 encryption; decryptUint8 and the uint8
        operations take it interchangeably with encryptUint8's."""
        return self._s.encrypt_uint8_bits_seeded(int(value))

    def decryptUint8(self, ct: str, key: str = "", token: str = "a.b", jwks: str = "") -> int:
        if not self._jwt_ok(token, jwks):
            raise PermissionError("JWT validation failed")
        return self._s.decrypt_uint8_bits(ct)

    def addUint8(self, c1: str, c2: str, key: str = "") -> str:
        return self._s.add_uint8_bits(c1, c2)

    def subtractUint8(self, c1: str, c2: str, key: str = "") -> str:
        return self._s.subtract_uint8_bits(c1, c2)

    def multiplyUint8(self, c1: str, c2: str, key: str = "") -> str:
        return self._s.multiply_uint8_bits(c1, c2)

    def lessThanUint8(self, c1: str, c2: str, key: str = "") -> str:
        """Encrypted (a < b) as a uint8 0/1 ciphertext."""
        return self._s.less_than_uint8_bits(c1, c2)

    def equalsUint8(self, c1: str, c2: str, key: str = "") -> str:
        """Encrypted (a == b) as a uint8 0/1 ciphertext."""
        return self._s.equals_uint8_bits(c1, c2)

    def selectUint8(self, c: str, c1: str, c2: str, key: str = "") -> str:
        """Encrypted select: bit 0 of c picks c1 (1) or c2 (0)."""
        return self._s.select_uint8_bits(c, c1, c2)
