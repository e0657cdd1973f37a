"""Byte tokenizer (copy of ``repro.data.tokenizer``)."""
