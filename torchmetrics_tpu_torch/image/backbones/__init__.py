"""The feature networks of the generative image metrics: InceptionV3 and the LPIPS pyramids."""
