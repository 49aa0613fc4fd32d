"""Process configuration (a trimmed copy of ``dynamo_tpu.utils``)."""
