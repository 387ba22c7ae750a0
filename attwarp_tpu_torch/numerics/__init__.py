"""int8 numerics: the KV-cache quantizer and the linear/logit forms."""
