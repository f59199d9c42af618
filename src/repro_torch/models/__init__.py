"""Decoder model: layers, attention, FFN, decoder, registry."""
