"""Simulator services: snapshot, reset, resource watcher, cluster import.

These sit above the cluster store and below the HTTP handlers, mirroring
the reference's service layer (SURVEY.md §2.1 #13-16).
"""
