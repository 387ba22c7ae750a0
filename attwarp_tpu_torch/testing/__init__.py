"""Test and evidence helpers: the reader proxy backend and code-tag scenes."""
