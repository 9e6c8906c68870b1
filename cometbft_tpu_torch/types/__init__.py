"""Data model: commits, validator sets, canonical sign bytes, and
commit verification."""
