"""Reading HF checkpoints for both backends' ``from_hf``.

``transformers`` is imported only here, inside the functions: the rest of
the port runs without it. Config fields are read so that what
``transformers`` 4.x writes and what 5.x writes both load: 5.x moved
``rope_theta``/``rope_scaling`` into ``rope_parameters``, renamed LLaVA's
``image_token_index`` to ``image_token_id`` and ``from_pretrained``'s
``torch_dtype`` to ``dtype`` (which 4.57 reads too). Checkpoints are read
from local files only (``local_files_only``): a directory, or a hub id
already in the local HF cache; nothing is downloaded.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def first_defined(*vals):
    """The first value that is not None (0 is a valid token id)."""
    for v in vals:
        if v is not None:
            return v
    return None


def scalar_id(tok, default: int) -> int:
    """One token id from an HF field that may be a list (e.g. eos [2,
    32000]: the first), or ``default`` where it is unset."""
    if isinstance(tok, (list, tuple)):
        tok = tok[0] if tok else None
    return int(tok) if tok is not None else default


def rope_field(text_cfg, name: str, default: Any) -> Any:
    """``name`` (``rope_theta``, ``mrope_section``) of a text config:
    from ``rope_parameters`` (transformers 5.x), else ``rope_scaling``, else
    the attribute itself, else ``default``."""
    for group in ("rope_parameters", "rope_scaling"):
        d = getattr(text_cfg, group, None)
        if isinstance(d, dict) and d.get(name) is not None:
            return d[name]
    return first_defined(getattr(text_cfg, name, None), default)


def load_hf_model(model_cls: str, path: str, dtype: Optional[torch.dtype]):
    """``transformers.<model_cls>.from_pretrained(path)`` from local files,
    on the CPU, its weights in ``dtype`` (f32 where None), in eval mode."""
    import transformers

    cls = getattr(transformers, model_cls)
    return cls.from_pretrained(path, dtype=dtype or torch.float32,
                               local_files_only=True).eval()


def processor_tokenizer(path: str):
    """The tokenizer of the processor saved at ``path``, or None where no
    processor loads there (a weights-only checkpoint: ids-level use only,
    or a tokenizer attached later), as the JAX ``from_hf`` does."""
    from transformers import AutoProcessor

    try:
        return AutoProcessor.from_pretrained(path, local_files_only=True).tokenizer
    except Exception as e:  # noqa: BLE001 - any failure means "no processor here"
        print(f"[from_hf] no processor at {path} ({type(e).__name__}); text-level "
              "extract disabled until a tokenizer is attached")
        return None
