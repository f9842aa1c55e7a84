"""Host-side data utilities: RLE codec and OpenCV-exact resizes."""
