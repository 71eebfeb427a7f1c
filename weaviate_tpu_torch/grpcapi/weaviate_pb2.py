# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: weaviate.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eweaviate.proto\x12\x0eweaviatetpu.v1\"l\n\x10NearVectorParams\x12\x0e\n\x06vector\x18\x01 \x03(\x02\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x42\x0c\n\n_certaintyB\x0b\n\t_distance\"h\n\x10NearObjectParams\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\tcertainty\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x01\x88\x01\x01\x42\x0c\n\n_certaintyB\x0b\n\t_distance\"/\n\nBM25Params\x12\r\n\x05query\x18\x01 \x01(\t\x12\x12\n\nproperties\x18\x02 \x03(\t\"`\n\x0cHybridParams\x12\r\n\x05query\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x12\n\x05\x61lpha\x18\x03 \x01(\x02H\x00\x88\x01\x01\x12\x13\n\x0b\x66usion_type\x18\x04 \x01(\tB\x08\n\x06_alpha\"\xea\x02\n\rSearchRequest\x12\x12\n\nclass_name\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\r\x12\x12\n\nproperties\x18\x04 \x03(\t\x12\x1d\n\x15\x61\x64\x64itional_properties\x18\x05 \x03(\t\x12\x35\n\x0bnear_vector\x18\x06 \x01(\x0b\x32 .weaviatetpu.v1.NearVectorParams\x12\x35\n\x0bnear_object\x18\x07 \x01(\x0b\x32 .weaviatetpu.v1.NearObjectParams\x12(\n\x04\x62m25\x18\x08 \x01(\x0b\x32\x1a.weaviatetpu.v1.BM25Params\x12,\n\x06hybrid\x18\t \x01(\x0b\x32\x1c.weaviatetpu.v1.HybridParams\x12\x12\n\nwhere_json\x18\n \x01(\t\x12\x19\n\x11\x63onsistency_level\x18\x0b \x01(\t\"\xfd\x01\n\x0cSearchResult\x12\n\n\x02id\x18\x01 \x01(\t\x12\x17\n\x0fproperties_json\x18\x02 \x01(\t\x12\x15\n\x08\x64istance\x18\x03 \x01(\x01H\x00\x88\x01\x01\x12\x16\n\tcertainty\x18\x04 \x01(\x01H\x01\x88\x01\x01\x12\x12\n\x05score\x18\x05 \x01(\x01H\x02\x88\x01\x01\x12\x0e\n\x06vector\x18\x06 \x03(\x02\x12\x1a\n\x12\x63reation_time_unix\x18\x07 \x01(\x03\x12\x1d\n\x15last_update_time_unix\x18\x08 \x01(\x03\x12\x15\n\rexplain_score\x18\t \x01(\tB\x0b\n\t_distanceB\x0c\n\n_certaintyB\x08\n\x06_score\"i\n\x0bSearchReply\x12-\n\x07results\x18\x01 \x03(\x0b\x32\x1c.weaviatetpu.v1.SearchResult\x12\x14\n\x0ctook_seconds\x18\x02 \x01(\x02\x12\x15\n\rerror_message\x18\x03 \x01(\t\"E\n\x12\x42\x61tchSearchRequest\x12/\n\x08requests\x18\x01 \x03(\x0b\x32\x1d.weaviatetpu.v1.SearchRequest\"@\n\x10\x42\x61tchSearchReply\x12,\n\x07replies\x18\x01 \x03(\x0b\x32\x1b.weaviatetpu.v1.SearchReply2\xa5\x01\n\x08Weaviate\x12\x44\n\x06Search\x12\x1d.weaviatetpu.v1.SearchRequest\x1a\x1b.weaviatetpu.v1.SearchReply\x12S\n\x0b\x42\x61tchSearch\x12\".weaviatetpu.v1.BatchSearchRequest\x1a .weaviatetpu.v1.BatchSearchReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'weaviate_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NEARVECTORPARAMS._serialized_start=34
  _NEARVECTORPARAMS._serialized_end=142
  _NEAROBJECTPARAMS._serialized_start=144
  _NEAROBJECTPARAMS._serialized_end=248
  _BM25PARAMS._serialized_start=250
  _BM25PARAMS._serialized_end=297
  _HYBRIDPARAMS._serialized_start=299
  _HYBRIDPARAMS._serialized_end=395
  _SEARCHREQUEST._serialized_start=398
  _SEARCHREQUEST._serialized_end=760
  _SEARCHRESULT._serialized_start=763
  _SEARCHRESULT._serialized_end=1016
  _SEARCHREPLY._serialized_start=1018
  _SEARCHREPLY._serialized_end=1123
  _BATCHSEARCHREQUEST._serialized_start=1125
  _BATCHSEARCHREQUEST._serialized_end=1194
  _BATCHSEARCHREPLY._serialized_start=1196
  _BATCHSEARCHREPLY._serialized_end=1260
  _WEAVIATE._serialized_start=1263
  _WEAVIATE._serialized_end=1428
# @@protoc_insertion_point(module_scope)
