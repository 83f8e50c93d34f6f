"""The host data path of the port: image files, cv2's operations, geometry,
the nuScenes dataset and its loader, in numpy (no pandas, PIL or cv2)."""
