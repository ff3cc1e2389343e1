"""The web GUI (webgui.py)."""
