"""Utilities: config overrides, generators, health guard, metrics, weight transplant, kernel builds."""
