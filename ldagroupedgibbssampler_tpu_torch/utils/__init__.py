"""Run-directory logging, console capture and device selection."""
