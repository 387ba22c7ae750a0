"""Numerics: the int8 KV-cache quantizer, the linear/logit forms and adaptive pooling."""
