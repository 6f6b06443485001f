"""Procedural and reference scenes."""
