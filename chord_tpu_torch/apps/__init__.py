"""The viewer and the editor (ports of apps/viewer.py and apps/editor.py)."""
