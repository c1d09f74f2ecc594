"""Launchers of the port (token serving so far)."""
