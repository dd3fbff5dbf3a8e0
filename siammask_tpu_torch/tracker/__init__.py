"""Tracker (one object, O objects, whole videos), its host runtime and the VOS and VOT drivers."""
