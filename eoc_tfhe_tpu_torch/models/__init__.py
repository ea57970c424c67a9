"""Model families: the llama tier.

Port of ``eoc_tfhe_tpu/models``.  ``llama`` is the equivalent of upstream's
co-resident llama.cpp engine (the AO-Llama submodule, SURVEY.md §2.3):
layer-stacked weights, a static KV cache, bf16 products with float32
accumulation.  ``checkpoint`` and ``tokenizer`` are the llama2.c formats,
``publish`` the chunked model chain, ``ao_llama`` the backend behind the
process's ``Llama`` table.
"""

from . import llama, checkpoint, tokenizer  # noqa: F401
from .llama import LlamaConfig, forward, generate, init_params  # noqa: F401
