"""Core types, mesh geometry and node-agent config (L0) of the port."""
