"""Ported model layers and stacks."""
