"""The node registry (ClientMode): see server.py."""
