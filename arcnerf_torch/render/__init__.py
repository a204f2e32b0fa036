"""Rendering: rays and compositing (kernel C), the camera, the render engine."""
